"""Batch assembly: Collate to fixed padded shapes + DataFetcher policy.

Capability parity with ``pb_sed/data_preparation/fetcher.py:6-52``
(prefetch, optional shuffles, dynamic bucketing, Collate, final prefetch)
and padertorch ``Collate`` (pad variable-length arrays, stack, keep lists
for non-array fields).

Collate pads every batch to its bucket's palette length (frames) and pads
the waveform to exactly the sample count that yields that many STFT frames
(``STFT.num_samples_for_frames``), so the device sees a small set of fixed
shapes.

Multi-host sharding (``num_shards > 1``; SURVEY.md §2.4/§7 "hard part"):
``batch_size`` is the GLOBAL batch size. Two shard levels:

- ``shard_level='batch'`` (default, exact): every host runs the identical
  bucketing with the global batch size and the FULL
  ``min_dataset_examples_in_batch`` / ``min_label_diversity_in_batch``
  quotas — so the reference's per-batch composition contract holds for
  the GLOBAL batch — then takes its interleaved slice of each assembled
  batch. All hosts see the same palette length per step (the pad length
  is computed from the global batch BEFORE slicing). Requires identically
  seeded upstream pipelines across hosts.
- ``shard_level='example'`` (approximate, decode-sharded): each host
  buckets only every ``num_shards``-th example with ``batch_size /
  num_shards`` and deterministically split per-shard quotas
  (``quota // n + (i < quota % n)``); the global batch then satisfies the
  dataset quotas exactly and the label diversity up to
  ``min(diversity, local_batch)``. Use for decode-bound corpora
  (AudioSet) where n-fold duplicate decoding is unacceptable.

  STEP ALIGNMENT: hash-of-clip-id membership makes per-host shard sizes
  (and batch counts) unequal. In a multi-process SPMD loop every step is
  a collective, so the host with the smallest shard would exit the epoch
  loop first while the others block — a hang. Set ``steps_per_epoch``
  (every host truncates its stream to the same count); every host can
  compute an agreed budget without communication via
  :meth:`aligned_steps_per_epoch` (min membership count over shards,
  from ``lazy.shard_membership_counts``).
"""
import warnings

import dataclasses

import numpy as np

from pb_sed_tpu_torch.data.bucketing import (
    DynamicBucketDataset, DynamicTimeSeriesBucket)
from pb_sed_tpu_torch.utils.config import Configurable


HOST_KEYS = ('example_id', 'dataset')


@dataclasses.dataclass
class Collate:
    """List of example dicts -> batch dict of stacked padded arrays."""
    pad_frames_to: int = None          # palette length (None: batch max)
    frames_to_samples: object = None   # callable T -> S (from STFT geometry)
    pad_samples_to: int = None         # waveform pad (None: derive)
    # 'int16' quantizes the waveform at ops.features.AUDIO_INT16_SCALE
    # (8x headroom over per-instance normalization) — halves the
    # host->device batch bytes; the feature extractor dequantizes on
    # device. Use on transfer-bound hosts (remote links, busy PCIe).
    audio_dtype: str = 'float32'

    def __call__(self, examples):
        assert len(examples) > 0
        batch = {}
        keys = examples[0].keys()
        max_frames = max(ex['seq_len'] for ex in examples)
        t_pad = self.pad_frames_to or max_frames
        if self.pad_samples_to is not None:
            s_pad = self.pad_samples_to
        elif callable(self.frames_to_samples):
            s_pad = int(self.frames_to_samples(t_pad))
        else:
            s_pad = max(
                np.shape(ex.get('audio_data', []))[-1] for ex in examples)
        for key in keys:
            values = [ex[key] for ex in examples]
            first = values[0]
            if key in HOST_KEYS or isinstance(first, str):
                batch[key] = values
            elif key == 'audio_data':
                if self.audio_dtype == 'int16':
                    from pb_sed_tpu_torch.ops.features import AUDIO_INT16_SCALE
                    out = _fill_padded(values, s_pad, np.float32)
                    np.multiply(out, AUDIO_INT16_SCALE, out=out)
                    batch[key] = np.clip(
                        out, -32768, 32767).astype(np.int16)
                else:
                    batch[key] = _fill_padded(values, s_pad, np.float32)
            elif isinstance(first, np.ndarray) and first.ndim >= 1:
                # (K,) stacks directly; (K, T) pads time
                if first.ndim >= 2 or key.endswith('_targets') \
                        and first.ndim == 2:
                    batch[key] = _fill_padded(values, t_pad)
                else:
                    batch[key] = np.stack([np.asarray(v) for v in values])
            else:
                batch[key] = np.asarray(values)
        if 'seq_len' in batch:
            batch['seq_len'] = np.asarray(batch['seq_len'], np.int32)
        if 'seq_len_samples' in batch:
            batch['seq_len_samples'] = np.asarray(
                batch['seq_len_samples'], np.int32)
        return batch


def _fill_padded(values, target, dtype=None):
    """Stack variable-length arrays into ONE preallocated zero buffer
    padded/truncated to ``target`` on the last axis — a single copy per
    example instead of pad-then-stack (two copies; np.stack dominated
    the measured host-collate time)."""
    first = np.asarray(values[0])
    out = np.zeros(
        (len(values),) + first.shape[:-1] + (target,),
        dtype or first.dtype)
    for i, v in enumerate(values):
        v = np.asarray(v)
        n = min(v.shape[-1], target)
        out[i, ..., :n] = v[..., :n]
    return out


def _process_group():
    """(world size, rank) of ``torch.distributed``'s default process
    group; (1, 0) where none is initialized."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def split_quota(quota, num_shards, shard_index):
    """Deterministic per-shard share of a global per-batch quota:
    shards 0..(quota % n - 1) take the remainder."""
    return quota // num_shards + int(shard_index < quota % num_shards)


@dataclasses.dataclass
class DataFetcher(Configurable):
    """Batching policy (reference ``DataFetcher`` surface + palette knobs)."""
    prefetch_workers: int = 2
    global_shuffle: bool = False
    local_shuffle_buffer_size: int = 0
    batch_size: int = None             # GLOBAL batch size
    max_padding_rate: float = 0.1
    pad_to_multiple: int = 64
    min_label_diversity_in_batch: int = 0
    min_dataset_examples_in_batch: dict = None
    bucket_expiration: int = None
    max_bucket_buffer_size: int = None
    drop_incomplete: bool = False
    # multi-host sharding: None = infer from torch.distributed's process
    # group (one shard without one)
    num_shards: int = None
    shard_index: int = None
    shard_level: str = 'batch'         # 'batch' (exact) | 'example'
    # example-level sharding: agreed per-epoch batch budget so every
    # host runs the same number of (collective) steps; see module
    # docstring + aligned_steps_per_epoch
    steps_per_epoch: int = None
    # batch-level sharding needs IDENTICAL shuffles on every host
    shard_shuffle_seed: int = 0
    # wired by the provider: STFT geometry config for exact waveform padding
    stft: dict = None
    # waveform transport dtype (see Collate.audio_dtype)
    audio_dtype: str = 'float32'

    def _shard_plan(self):
        num_shards, shard_index = self.num_shards, self.shard_index
        if num_shards is None or (num_shards > 1 and shard_index is None):
            # shard_index inferred INDEPENDENTLY of num_shards: a shared
            # config may pin num_shards while every host must still
            # discover its own index
            world_size, rank = _process_group()
            if num_shards is None:
                num_shards = world_size
            if shard_index is None:
                shard_index = rank
        return num_shards, (shard_index or 0)

    def __call__(self, dataset, batched_input=False):
        assert self.batch_size is None or self.batch_size >= 1, \
            f'batch_size must be >= 1, got {self.batch_size}'
        assert self.shard_level in ('batch', 'example'), self.shard_level
        num_shards, shard_index = self._shard_plan()
        sharded_examples = (
            num_shards > 1 and (self.shard_level == 'example'
                                or self.batch_size is None))
        if self.global_shuffle:
            # shuffle BEFORE hash-sharding: the shard stream is
            # iterator-only, and hash membership is order-independent
            rng = None
            if num_shards > 1:
                # every host must draw the identical permutation
                rng = np.random.RandomState(self.shard_shuffle_seed)
            dataset = dataset.shuffle(reshuffle=True, rng=rng)
        if self.prefetch_workers > 0:
            dataset = dataset.prefetch(
                self.prefetch_workers, 2 * self.prefetch_workers)
        if batched_input:
            dataset = dataset.unbatch()
        if sharded_examples:
            # hash-of-id membership (positional round-robin can alias
            # with the proportional source interleave and starve a shard
            # of an entire source dataset); applied AFTER unbatch so
            # segmented inputs hash per segment dict, with the segment
            # suffix stripped so all segments of a clip share a shard
            from pb_sed_tpu_torch.data.lazy import HashShardDataset
            dataset = HashShardDataset(dataset, num_shards, shard_index)
        if self.local_shuffle_buffer_size > 0 and not self.global_shuffle:
            rng = None
            if num_shards > 1 and not sharded_examples:
                # batch-level sharding: identical buffers on every host
                rng = np.random.RandomState(self.shard_shuffle_seed)
            dataset = dataset.shuffle(
                buffer_size=self.local_shuffle_buffer_size, rng=rng)
        if self.batch_size is None:
            return dataset
        if sharded_examples:
            assert self.batch_size % num_shards == 0, (
                self.batch_size, num_shards)
            batch_size = self.batch_size // num_shards
            quotas = {
                name: split_quota(quota, num_shards, shard_index)
                for name, quota in
                (self.min_dataset_examples_in_batch or {}).items()
            }
            diversity = min(self.min_label_diversity_in_batch, batch_size)
        else:
            if num_shards > 1:
                # the global-slice would silently drop len % n examples
                # from EVERY batch otherwise
                assert self.batch_size % num_shards == 0, (
                    self.batch_size, num_shards)
            batch_size = self.batch_size
            quotas = self.min_dataset_examples_in_batch
            diversity = self.min_label_diversity_in_batch
        bucketer = DynamicBucketDataset(
            dataset, DynamicTimeSeriesBucket,
            batch_size=batch_size,
            len_key='seq_len',
            max_padding_rate=self.max_padding_rate,
            pad_to_multiple=self.pad_to_multiple,
            min_label_diversity=diversity,
            label_key='weak_targets',
            min_dataset_examples=quotas,
            expiration=self.bucket_expiration,
            max_buffered_examples=self.max_bucket_buffer_size,
            drop_incomplete=self.drop_incomplete,
            sort_key='seq_len', reverse_sort=True,
        )
        multiple = self.pad_to_multiple
        frames_to_samples = None
        if self.stft is not None:
            from pb_sed_tpu_torch.ops.stft import STFT
            if isinstance(self.stft, STFT):
                geometry = self.stft
            else:
                cfg = {k: v for k, v in dict(self.stft).items()
                       if k != 'factory'}
                geometry = STFT(**cfg)
            frames_to_samples = geometry.num_samples_for_frames

        take_global_slice = num_shards > 1 and not sharded_examples

        def collate(batch):
            # palette length + waveform pad from the FULL batch (before
            # any shard slicing) so every host compiles the same shapes;
            # the SAME rung function as the bucketer so the pad equals
            # the bucket rung (max_padding_rate holds per example)
            from pb_sed_tpu_torch.data.bucketing import palette_length
            t_pad = palette_length(
                max(ex['seq_len'] for ex in batch), multiple,
                self.max_padding_rate)
            if frames_to_samples is not None:
                s_pad = int(frames_to_samples(t_pad))
            else:
                s_pad = max(np.shape(ex.get('audio_data', []))[-1]
                            for ex in batch)
            if take_global_slice:
                rem = len(batch) % num_shards
                if rem:
                    # partial batch (bucket expiration / end-of-stream
                    # drain): pad by REPEATING examples — deterministic,
                    # so every host pads identically — instead of
                    # silently dropping len % n examples from scoring.
                    # Duplicated example_ids overwrite in score dicts
                    # (metrics stay exact); loss summaries weight the
                    # repeated clips twice, which beats never scoring
                    # them on any host.
                    pad = num_shards - rem
                    batch = list(batch) + [
                        batch[j % len(batch)] for j in range(pad)]
                # CONTIGUOUS slices: process p's devices hold global
                # rows [p*n_local, (p+1)*n_local) under
                # make_array_from_process_local_data, so the assembled
                # global array preserves the bucketer's batch order
                n_local = len(batch) // num_shards
                batch = batch[shard_index * n_local:
                              (shard_index + 1) * n_local]
            return Collate(
                pad_frames_to=t_pad, frames_to_samples=frames_to_samples,
                pad_samples_to=s_pad,
                audio_dtype=self.audio_dtype)(batch)

        batched = bucketer.map(collate)
        if sharded_examples:
            if self.steps_per_epoch is not None:
                batched = _TakeN(batched, self.steps_per_epoch)
            else:
                if _process_group()[0] > 1:
                    warnings.warn(
                        "shard_level='example' without steps_per_epoch "
                        'in a multi-process run: per-host batch counts '
                        'differ (hash shards are unequal), so hosts can '
                        'deadlock in collectives at epoch end. Set '
                        'steps_per_epoch (see aligned_steps_per_epoch).',
                        RuntimeWarning, stacklevel=2)
        return batched.prefetch(1, 4)

    def aligned_steps_per_epoch(self, example_ids):
        """Agreed per-epoch batch budget for ``shard_level='example'``:
        min hash-membership count over shards // local batch size. Every
        host computes the identical value from the (pre-shard) id list.
        Conservative only up to bucketing: strict per-batch quotas or
        ``drop_incomplete`` can hold additional examples back — reduce
        the budget accordingly if the bucketer is configured tightly."""
        from pb_sed_tpu_torch.data.lazy import shard_membership_counts
        num_shards, _ = self._shard_plan()
        assert num_shards > 1 and self.batch_size, (
            num_shards, self.batch_size)
        counts = shard_membership_counts(example_ids, num_shards)
        return min(counts) // (self.batch_size // num_shards)


class _TakeN:
    """Streaming truncation to the first ``n`` batches (the agreed
    step budget in example-level shard mode). Running DRY before the
    budget is an ERROR, not an early exit: this host would silently
    stop stepping while the others block in collectives — the exact
    hang the budget exists to prevent. (The budget from
    ``aligned_steps_per_epoch`` is an upper bound when bucketing drops
    per-palette leftovers or strict quotas hold examples back — reduce
    it accordingly; the loud failure here is what surfaces that.)"""

    def __init__(self, parent, n):
        self.parent = parent
        self.n = int(n)

    def __iter__(self):
        it = iter(self.parent)
        for i in range(self.n):
            try:
                yield next(it)
            except StopIteration:
                raise RuntimeError(
                    f'sharded batch stream ran dry after {i} of the '
                    f'agreed steps_per_epoch={self.n} batches; other '
                    f'hosts would deadlock in collectives. Lower '
                    f'steps_per_epoch to what the bucketing policy '
                    f'actually emits (drop_incomplete / quotas / '
                    f'palette spread reduce the per-host batch count '
                    f'below min_membership // local_batch_size).'
                ) from None

    def __len__(self):
        # upper bound: the parent may run dry earlier
        raise TypeError(
            'streaming shard wrapper has no exact length; iterate it')

    def prefetch(self, num_workers=1, buffer_size=4):
        from pb_sed_tpu_torch.data.lazy import PrefetchDataset
        return PrefetchDataset(self, num_workers, buffer_size)
