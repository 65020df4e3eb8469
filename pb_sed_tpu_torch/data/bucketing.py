"""Dynamic bucketing into a fixed palette of padded shapes.

Capability parity with padertorch ``DynamicExtendedTimeSeriesBucket``
(``pb_sed/data_preparation/fetcher.py:38-51``): streaming batcher that
groups examples of similar ``seq_len``, enforces ``min_label_diversity``
and per-source ``min_dataset_examples`` quotas, supports expiration,
bounded buffering and ``drop_incomplete``.

Instead of the reference's continuous ``max_padding_rate`` bucket
boundaries (which yield arbitrary batch shapes), examples are bucketed
into a *quantized length palette* — padded lengths are rounded up to a multiple of a rung
granularity that adapts to the sequence length: ``pad_to_multiple`` for
long sequences, halving (powers of two) for short ones so that
``max_padding_rate`` holds as a HARD constraint for every example (the
reference treats it as hard too,
``pb_sed/data_preparation/fetcher.py:38-51``). The kernels pad time
internally to their own block multiples, so non-multiple-of-8 rungs are
legal; the palette bounds the number of distinct batch shapes
(<= ~log2(pad_to_multiple) / max_padding_rate rungs over the whole length
range, and exactly one rung for length-homogeneous corpora like 10 s DESED
clips).
"""
import numpy as np


def palette_length(seq_len, pad_to_multiple, max_padding_rate=None):
    """Smallest palette rung >= ``seq_len``.

    Rungs are multiples of a power-of-two granularity ``g <=
    pad_to_multiple`` chosen so the quantization tail keeps the padding
    rate within ``max_padding_rate``: ``R - L <= g - 1 <= p*L/(1-p)``
    implies ``(R - L) / R <= p``.
    """
    seq_len = int(seq_len)
    m = int(pad_to_multiple)
    if max_padding_rate is not None and seq_len > 0:
        p = float(max_padding_rate)
        limit = p * seq_len / (1. - p) + 1.
        g = 1
        while g * 2 <= min(limit, m):
            g *= 2
        m = g
    return int(-(-seq_len // m) * m)


class DynamicTimeSeriesBucket:
    """One open bucket: examples of one palette length awaiting a batch."""

    def __init__(self, batch_size, min_label_diversity=0, label_key=None,
                 min_dataset_examples=None):
        self.batch_size = batch_size
        self.min_label_diversity = min_label_diversity
        self.label_key = label_key
        self.min_dataset_examples = dict(min_dataset_examples or {})
        self.examples = []

    def add(self, example):
        self.examples.append(example)

    def _labels_of(self, example):
        targets = example.get(self.label_key)
        if targets is None:
            return set()
        targets = np.asarray(targets)
        return set(np.nonzero(targets > .99)[0].tolist())

    def try_assemble(self):
        """Return a valid batch (and keep the leftovers), or None."""
        if len(self.examples) < self.batch_size:
            return None
        # honor per-dataset quotas first, then label diversity, then fill
        chosen = []
        remaining = list(self.examples)
        for ds_name, quota in self.min_dataset_examples.items():
            picked = [ex for ex in remaining
                      if ex.get('dataset') == ds_name][:quota]
            if len(picked) < quota:
                return None
            for ex in picked:
                remaining.remove(ex)
            chosen.extend(picked)
        if self.min_label_diversity > 0:
            labels = set()
            for ex in chosen:
                labels |= self._labels_of(ex)
            for ex in list(remaining):
                if len(chosen) >= self.batch_size:
                    break
                new = self._labels_of(ex) - labels
                if len(labels) < self.min_label_diversity and new:
                    chosen.append(ex)
                    remaining.remove(ex)
                    labels |= new
            if len(labels) < self.min_label_diversity:
                return None
        while len(chosen) < self.batch_size and remaining:
            chosen.append(remaining.pop(0))
        if len(chosen) < self.batch_size:
            return None
        self.examples = remaining
        return chosen


class DynamicBucketDataset:
    """Streaming bucketer over a parent dataset (lazy iterator)."""

    def __init__(
            self, parent, bucket_cls=DynamicTimeSeriesBucket, *,
            batch_size, len_key='seq_len', max_padding_rate=None,
            pad_to_multiple=64, min_label_diversity=0, label_key=None,
            min_dataset_examples=None, expiration=None,
            max_buffered_examples=None, drop_incomplete=False,
            sort_key='seq_len', reverse_sort=True):
        self.parent = parent
        self.bucket_cls = bucket_cls
        self.batch_size = batch_size
        self.len_key = len_key
        self.max_padding_rate = max_padding_rate
        self.pad_to_multiple = pad_to_multiple
        self.min_label_diversity = min_label_diversity
        self.label_key = label_key
        self.min_dataset_examples = min_dataset_examples
        self.expiration = expiration
        self.max_buffered_examples = max_buffered_examples
        self.drop_incomplete = drop_incomplete
        self.sort_key = sort_key
        self.reverse_sort = reverse_sort

    def palette_length(self, seq_len):
        length = palette_length(
            seq_len, self.pad_to_multiple, self.max_padding_rate)
        assert (self.max_padding_rate is None or seq_len <= 0
                or (length - seq_len) / length <= self.max_padding_rate), (
            seq_len, length, self.max_padding_rate)
        return length

    def _finish(self, batch):
        if self.sort_key is not None:
            batch = sorted(batch, key=lambda ex: ex[self.sort_key],
                           reverse=self.reverse_sort)
        return batch

    def _flush(self, stale):
        """Flush a stale bucket in batch_size CHUNKS (a flush must never
        emit an over-sized batch outside the compiled palette); a
        trailing partial chunk honors ``drop_incomplete``."""
        for i in range(0, len(stale), self.batch_size):
            chunk = stale[i:i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_incomplete:
                continue
            if chunk:
                yield self._finish(chunk)

    def __iter__(self):
        buckets = {}
        ages = {}
        buffered = 0
        for example in self.parent:
            length = self.palette_length(example[self.len_key])
            bucket = buckets.get(length)
            if bucket is None:
                bucket = buckets[length] = self.bucket_cls(
                    self.batch_size,
                    min_label_diversity=self.min_label_diversity,
                    label_key=self.label_key,
                    min_dataset_examples=self.min_dataset_examples)
                ages[length] = 0
            bucket.add(example)
            buffered += 1
            for key in list(buckets):
                ages[key] += 1
            batch = bucket.try_assemble()
            if batch is not None:
                buffered -= len(batch)
                ages[length] = 0
                yield self._finish(batch)
            # expiration: flush the oldest bucket
            if self.expiration is not None:
                for key in list(buckets):
                    if ages[key] > self.expiration:
                        stale = buckets.pop(key).examples
                        del ages[key]
                        buffered -= len(stale)
                        yield from self._flush(stale)
            if (self.max_buffered_examples is not None
                    and buffered > self.max_buffered_examples):
                # flush the fullest bucket to relieve pressure
                key = max(buckets, key=lambda k: len(buckets[k].examples))
                stale = buckets.pop(key).examples
                del ages[key]
                buffered -= len(stale)
                yield from self._flush(stale)
        # drain
        leftovers = [ex for b in buckets.values() for ex in b.examples]
        if leftovers and not self.drop_incomplete:
            by_len = {}
            for ex in leftovers:
                by_len.setdefault(
                    self.palette_length(ex[self.len_key]), []).append(ex)
            for length in sorted(by_len):
                batch = by_len[length]
                for i in range(0, len(batch), self.batch_size):
                    yield self._finish(batch[i:i + self.batch_size])

    @property
    def indexable(self):
        return False

    def map(self, fn):
        from pb_sed_tpu_torch.data.lazy import MapDataset
        return MapDataset(self, fn)

    def prefetch(self, num_workers=1, buffer_size=4):
        from pb_sed_tpu_torch.data.lazy import PrefetchDataset
        return PrefetchDataset(self, num_workers, buffer_size)

    def __len__(self):
        # an estimate (exact length depends on quota interactions)
        return max(1, len(self.parent) // self.batch_size)
