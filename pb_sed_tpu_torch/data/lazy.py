"""Lazy functional dataset pipeline + JsonDatabase.

Capability parity with the ``lazy_dataset`` package surface the reference
uses (SURVEY.md §2.3e): ``Dataset`` protocol with ``map`` / ``batch_map`` /
``filter`` / ``shuffle(reshuffle=True, buffer_size=...)`` / ``tile`` /
``cache`` / ``prefetch`` / ``batch`` / ``unbatch`` / ``copy(freeze)`` /
``sort`` / indexing & slicing, round-robin proportional ``intersperse``,
and ``JsonDatabase(json_path).get_dataset(name_or_list)`` over the
``{datasets: {name: {example_id: example}}}`` json layout.

Host-side, numpy/threads only (this feeds the device pipeline; the
reference's process-pool prefetch becomes a thread pool since the heavy
lifting — STFT/mel/aug — moved onto the device, see ops/features.py).
"""
import bisect
import itertools
import queue
import threading

import numpy as np

from pb_sed_tpu_torch.utils.misc import load_json


class Dataset:
    """Base class: lazily evaluated example sequence."""

    # -- protocol ------------------------------------------------------
    def __len__(self):
        raise NotImplementedError

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            raise NotImplementedError
        if isinstance(item, slice):
            return SliceDataset(self, list(range(*item.indices(len(self)))))
        if isinstance(item, (list, tuple, np.ndarray)):
            return SliceDataset(self, list(item))
        raise TypeError(type(item))

    @property
    def indexable(self):
        return True

    def copy(self, freeze=False):
        return self

    # -- transformations ----------------------------------------------
    def map(self, fn, num_workers=0, buffer_size=None):
        """Lazy per-example map; with ``num_workers > 1`` applications
        run on an ordered thread pool (:class:`ParallelMapDataset`) —
        only for fns with no sequential state (an fn drawing from a
        seeded rng would consume draws in pool order and break the
        identical-pipeline multi-host contract, fetcher.py docstring)."""
        if num_workers and num_workers > 1:
            return ParallelMapDataset(self, fn, num_workers, buffer_size)
        return MapDataset(self, fn)

    def batch_map(self, fn):
        return MapDataset(self, lambda batch: [fn(ex) for ex in batch])

    def filter(self, predicate, lazy=True):
        if lazy:
            raise NotImplementedError(
                'lazy filtering loses len(); use lazy=False like the '
                'reference call sites do')
        keep = [i for i, ex in enumerate(self) if predicate(ex)]
        return SliceDataset(self, keep)

    def shuffle(self, reshuffle=False, rng=None, buffer_size=None):
        if buffer_size is not None:
            return LocalShuffleDataset(self, buffer_size, rng=rng)
        return ShuffleDataset(self, reshuffle=reshuffle, rng=rng)

    def tile(self, reps, shuffle=False):
        ds = TileDataset(self, reps)
        if shuffle:
            ds = ds.shuffle(reshuffle=True)
        return ds

    def sort(self, key_fn, reverse=False):
        order = sorted(range(len(self)),
                       key=lambda i: key_fn(self[i]), reverse=reverse)
        return SliceDataset(self, order)

    def cache(self, lazy=True):
        return CacheDataset(self, lazy=lazy)

    def prefetch(self, num_workers=2, buffer_size=4):
        return PrefetchDataset(self, num_workers, buffer_size)

    def batch(self, batch_size, drop_last=False):
        return BatchDataset(self, batch_size, drop_last)

    def unbatch(self):
        return UnbatchDataset(self)

    def batch_dynamic_bucket(self, bucket_cls, **kwargs):
        from pb_sed_tpu_torch.data.bucketing import DynamicBucketDataset
        return DynamicBucketDataset(self, bucket_cls, **kwargs)


class DictDataset(Dataset):
    """Dataset over an ordered dict of examples; injects example_id."""

    def __init__(self, examples, name=None):
        self.examples = examples
        self.keys = list(examples.keys())
        self.name = name

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, item):
        if isinstance(item, str):
            key = item
        elif isinstance(item, (int, np.integer)):
            key = self.keys[item]
        else:
            return super().__getitem__(item)
        ex = dict(self.examples[key])
        ex.setdefault('example_id', key)
        if self.name is not None:
            ex.setdefault('dataset', self.name)
        return ex


class ListDataset(Dataset):
    def __init__(self, items):
        self.items = list(items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self.items[item]
        return super().__getitem__(item)


class SliceDataset(Dataset):
    def __init__(self, parent, indices):
        self.parent = parent
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self.parent[self.indices[item]]
        return super().__getitem__(item)

    def copy(self, freeze=False):
        return SliceDataset(self.parent.copy(freeze), self.indices)


class MapDataset(Dataset):
    def __init__(self, parent, fn):
        self.parent = parent
        self.fn = fn

    def __len__(self):
        return len(self.parent)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self.fn(self.parent[item])
        return super().__getitem__(item)

    def __iter__(self):
        for ex in self.parent:
            yield self.fn(ex)

    @property
    def indexable(self):
        return self.parent.indexable

    def copy(self, freeze=False):
        return MapDataset(self.parent.copy(freeze), self.fn)


class TileDataset(Dataset):
    def __init__(self, parent, reps):
        assert reps >= 1, reps
        self.parent = parent
        self.reps = int(reps)

    def __len__(self):
        return len(self.parent) * self.reps

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self.parent[item % len(self.parent)]
        return super().__getitem__(item)

    def copy(self, freeze=False):
        return TileDataset(self.parent.copy(freeze), self.reps)


class ShuffleDataset(Dataset):
    """Full permutation; ``reshuffle=True`` re-permutes every epoch."""

    def __init__(self, parent, reshuffle=False, rng=None):
        self.parent = parent
        self.reshuffle = reshuffle
        self.rng = rng or np.random.RandomState()
        self.permutation = self.rng.permutation(len(parent))

    def __len__(self):
        return len(self.parent)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self.parent[int(self.permutation[item])]
        return super().__getitem__(item)

    def __iter__(self):
        if self.reshuffle:
            self.permutation = self.rng.permutation(len(self.parent))
        for i in self.permutation:
            yield self.parent[int(i)]

    def copy(self, freeze=False):
        if freeze:
            return SliceDataset(self.parent.copy(True),
                                self.permutation.tolist())
        return ShuffleDataset(self.parent.copy(False), self.reshuffle,
                              self.rng)


class LocalShuffleDataset(Dataset):
    """Streaming shuffle with a bounded reservoir buffer."""

    def __init__(self, parent, buffer_size, rng=None):
        self.parent = parent
        self.buffer_size = buffer_size
        self.rng = rng or np.random.RandomState()

    def __len__(self):
        return len(self.parent)

    def __iter__(self):
        buffer = []
        for ex in self.parent:
            buffer.append(ex)
            if len(buffer) >= self.buffer_size:
                idx = self.rng.randint(len(buffer))
                buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                yield buffer.pop()
        self.rng.shuffle(buffer)
        yield from buffer

    @property
    def indexable(self):
        return False


class CacheDataset(Dataset):
    def __init__(self, parent, lazy=True):
        self.parent = parent
        self._cache = {}
        if not lazy:
            for i in range(len(parent)):
                self._cache[i] = parent[i]

    def __len__(self):
        return len(self.parent)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            item = int(item)
            if item not in self._cache:
                self._cache[item] = self.parent[item]
            return self._cache[item]
        return super().__getitem__(item)


class ParallelMapDataset(Dataset):
    """Ordered thread-pool map with bounded lookahead.

    One puller thread iterates the parent (cheap upstream work) and
    submits ``fn`` applications to ``num_workers`` pool threads; the
    consumer receives results in INPUT ORDER. The wav decode's numpy
    and scipy calls release the GIL, so workers scale with cores: the
    host-pipeline lever for feeding a
    chip that steps faster than one core can decode (reference prefetch
    design ``pb_sed/data_preparation/fetcher.py:19-52``; the reference
    used a process pool, which the int16/f32 waveform transport here
    would pay serialization for).

    ``fn`` must be thread-safe and draw no sequential randomness —
    parallel application reorders rng consumption (see Dataset.map).
    Iteration order and values are bit-identical to the sequential map.
    """

    def __init__(self, parent, fn, num_workers, buffer_size=None):
        self.parent = parent
        self.fn = fn
        self.num_workers = max(1, int(num_workers))
        self.buffer_size = int(buffer_size or 2 * self.num_workers)

    def __len__(self):
        return len(self.parent)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self.fn(self.parent[item])
        return super().__getitem__(item)

    @property
    def indexable(self):
        return self.parent.indexable

    def copy(self, freeze=False):
        return ParallelMapDataset(self.parent.copy(freeze), self.fn,
                                  self.num_workers, self.buffer_size)

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor
        # queue of in-flight futures, in submission order; maxsize
        # bounds decoded-example memory AND applies backpressure to
        # the puller
        q = queue.Queue(maxsize=self.buffer_size)
        sentinel = object()
        stop = threading.Event()
        pool = ThreadPoolExecutor(self.num_workers)

        def puller():
            try:
                for ex in self.parent:
                    if stop.is_set():
                        return
                    fut = pool.submit(self.fn, ex)
                    while not stop.is_set():
                        try:
                            q.put(fut, timeout=.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as exc:  # surfaced in consumer
                # same stop-aware timed put as the normal path: an
                # unbounded blocking put would leak this daemon thread
                # (and its pool) forever if the consumer already exited
                # with the queue full (ADVICE r4)
                while not stop.is_set():
                    try:
                        q.put(('__error__', exc), timeout=.1)
                        break
                    except queue.Full:
                        continue
            finally:
                try:
                    q.put_nowait(sentinel)
                except queue.Full:
                    # consumer gone (stop set): nothing reads anymore
                    pass

        thread = threading.Thread(target=puller, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == '__error__':
                    raise item[1]
                yield item.result()
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)


class PrefetchDataset(Dataset):
    """Background thread(s) fill a bounded queue ahead of the consumer."""

    def __init__(self, parent, num_workers, buffer_size):
        self.parent = parent
        self.num_workers = max(1, num_workers)
        self.buffer_size = max(1, buffer_size)

    def __len__(self):
        return len(self.parent)

    @property
    def indexable(self):
        return False

    def __iter__(self):
        q = queue.Queue(maxsize=self.buffer_size)
        sentinel = object()

        def producer():
            try:
                for ex in self.parent:
                    q.put(ex)
            except BaseException as exc:  # surfaced in consumer
                q.put(('__error__', exc))
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] == '__error__':
                raise item[1]
            yield item


class BatchDataset(Dataset):
    def __init__(self, parent, batch_size, drop_last=False):
        self.parent = parent
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.parent)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def __iter__(self):
        batch = []
        for ex in self.parent:
            batch.append(ex)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            start = item * self.batch_size
            stop = min(start + self.batch_size, len(self.parent))
            return [self.parent[i] for i in range(start, stop)]
        return super().__getitem__(item)


class UnbatchDataset(Dataset):
    def __init__(self, parent):
        self.parent = parent

    def __len__(self):
        raise TypeError('unbatched dataset has no deterministic length')

    @property
    def indexable(self):
        return False

    def __iter__(self):
        for batch in self.parent:
            yield from batch


class HashShardDataset(Dataset):
    """Shard membership by stable hash of ``example_id`` instead of
    stream position: positional round-robin can alias with the
    proportional source interleave and starve a shard of an entire
    source dataset (breaking per-batch dataset quotas); a content hash
    decorrelates the two."""

    def __init__(self, parent, num_shards, shard_index):
        assert 0 <= shard_index < num_shards, (shard_index, num_shards)
        self.parent = parent
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._hash = lambda ex: shard_of(ex['example_id'], num_shards)

    def __iter__(self):
        for ex in self.parent:
            if self._hash(ex) == self.shard_index:
                yield ex

    def __len__(self):
        # shard membership is content-dependent (hash of clip ids), so
        # any length would be an estimate; epoch accounting on it would
        # mis-align steps across hosts (see DataFetcher shard notes)
        raise TypeError(
            'HashShardDataset has no exact length; iterate it, or count '
            'memberships with shard_membership_counts()')

    @property
    def indexable(self):
        return False


def shard_of(example_id, num_shards):
    """THE shard-membership function: stable hash of the segment-
    stripped clip id (segments of one clip share a shard). Single
    source of truth for ``HashShardDataset`` and
    ``shard_membership_counts`` — they must agree bit-for-bit or the
    hosts' agreed step budgets address the wrong membership."""
    import zlib
    clip_id = str(example_id).split('_!segment!_')[0]
    return zlib.crc32(clip_id.encode()) % num_shards


def shard_membership_counts(example_ids, num_shards):
    """Per-shard membership counts for hash-of-clip-id sharding.

    Membership depends only on the clip ids, so EVERY host can compute
    ALL shards' counts from the (pre-shard) id list and agree on a
    per-epoch step budget (e.g. ``min(counts) // local_batch_size``)
    without communication — required for step-aligned multi-process
    training with ``shard_level='example'`` (see DataFetcher).
    """
    counts = [0] * num_shards
    for example_id in example_ids:
        counts[shard_of(example_id, num_shards)] += 1
    return counts


class ShardDataset(Dataset):
    """Every ``num_shards``-th example starting at ``shard_index`` — the
    per-host shard of a multi-host input pipeline (each host feeds its
    own data-parallel slice; SURVEY.md §5 multi-host input pipeline)."""

    def __init__(self, parent, num_shards, shard_index):
        assert 0 <= shard_index < num_shards, (shard_index, num_shards)
        self.parent = parent
        self.num_shards = num_shards
        self.shard_index = shard_index

    def __len__(self):
        n = len(self.parent)
        return (n - self.shard_index + self.num_shards - 1) \
            // self.num_shards

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return self.parent[self.shard_index
                               + int(item) * self.num_shards]
        return super().__getitem__(item)

    def __iter__(self):
        for i, ex in enumerate(self.parent):
            if i % self.num_shards == self.shard_index:
                yield ex

    @property
    def indexable(self):
        return self.parent.indexable

    def copy(self, freeze=False):
        return ShardDataset(self.parent.copy(freeze), self.num_shards,
                            self.shard_index)


class InterspersedDataset(Dataset):
    """Round-robin proportional interleave (lazy_dataset.intersperse)."""

    def __init__(self, *datasets):
        self.datasets = datasets
        self.lengths = [len(ds) for ds in datasets]
        total = sum(self.lengths)
        # proportional schedule: dataset d owns positions where the
        # cumulative quota of d increments
        order = []
        counts = [0] * len(datasets)
        for i in range(total):
            # pick the dataset most behind its proportional quota
            best = int(np.argmax([
                (self.lengths[d] * (i + 1)) // total - counts[d]
                for d in range(len(datasets))
            ]))
            order.append(best)
            counts[best] += 1
        self.order = order

    def __len__(self):
        return sum(self.lengths)

    def __iter__(self):
        iters = [iter(ds) for ds in self.datasets]
        for d in self.order:
            yield next(iters[d])

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            d = self.order[item]
            offset = sum(1 for x in self.order[:item] if x == d)
            return self.datasets[d][offset]
        return super().__getitem__(item)

    def copy(self, freeze=False):
        return InterspersedDataset(
            *[ds.copy(freeze) for ds in self.datasets])


def intersperse(*datasets):
    return InterspersedDataset(*datasets)


def from_dict(examples, name=None):
    return DictDataset(examples, name=name)


def from_list(items):
    return ListDataset(items)


def concatenate(*datasets):
    lengths = np.cumsum([0] + [len(ds) for ds in datasets])

    class _Concat(Dataset):
        def __len__(self_inner):
            return int(lengths[-1])

        def __getitem__(self_inner, item):
            if isinstance(item, (int, np.integer)):
                d = bisect.bisect_right(lengths, item) - 1
                return datasets[d][int(item - lengths[d])]
            return super().__getitem__(item)

        def __iter__(self_inner):
            return itertools.chain(*datasets)

    return _Concat()


class JsonDatabase:
    """Database over ``{datasets: {name: {clip_id: example}}}`` json."""

    def __init__(self, json_path=None, database_dict=None):
        assert json_path is not None or database_dict is not None
        self._json_path = json_path
        self._data = database_dict

    @property
    def data(self):
        if self._data is None:
            self._data = load_json(self._json_path)
        return self._data

    @property
    def dataset_names(self):
        return list(self.data['datasets'].keys())

    def get_dataset(self, name_or_list):
        if isinstance(name_or_list, (list, tuple)):
            return concatenate(*[
                self.get_dataset(name) for name in name_or_list])
        datasets = self.data['datasets']
        assert name_or_list in datasets, (
            name_or_list, list(datasets.keys()))
        return DictDataset(datasets[name_or_list], name=name_or_list)
