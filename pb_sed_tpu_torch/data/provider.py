"""DataProvider: the host-side data API feeding fixed-shape device batches.

Capability parity with ``pb_sed/data_preparation/provider.py:22-378``
(``get_train_set`` / ``get_validate_set`` / ``get_dataset`` / ``get_raw``
over a JsonDatabase, with example filtering, eager caching, per-dataset
repeats, per-class rebalancing, scale/mixture augmentation, transform and
batching). The port's own copy of ``pb_sed_tpu/data/provider.py`` (the
port imports nothing of the JAX package; keep the two in step):

- The training stream is assembled from an explicit **epoch plan**
  (:class:`EpochPlan`): every source contributes an index stream — its
  surviving example indices, replicated per the ``train_set`` repeat spec
  and per-example rebalancing repeats from :func:`rebalance_repeats` — and
  the streams are reshuffled every epoch and proportionally interleaved. The
  plan is pure data (index arrays over the raw datasets), which keeps the
  composition deterministic and host-splittable.
- Downstream, planned examples flow through scale/mixture augmentation
  into the ``Transform`` (target encoding; the STFT itself runs on
  device) and the palette bucketer (``DataFetcher``), which emits a small
  set of fixed padded shapes. Multi-host sharding happens inside the fetcher
  (``num_shards`` / ``shard_index``) AFTER the bucketing policy is fixed,
  so every host draws from the same palette.
"""
import dataclasses
import math
from typing import Callable

import numpy as np

from pb_sed_tpu_torch.data import lazy
from pb_sed_tpu_torch.data.audio import AudioReader
from pb_sed_tpu_torch.data.encoder import MultiHotAlignmentEncoder
from pb_sed_tpu_torch.data.fetcher import DataFetcher
from pb_sed_tpu_torch.data.lazy import JsonDatabase
from pb_sed_tpu_torch.data.mix import MixtureDataset, SuperposeEvents
from pb_sed_tpu_torch.data.transform import Transform
from pb_sed_tpu_torch.ops.stft import STFT
from pb_sed_tpu_torch.utils.config import Configurable
from pb_sed_tpu_torch.utils.misc import to_list
from pb_sed_tpu_torch.utils.random import LogTruncatedNormal, Uniform


def example_labels(dataset, label_key):
    """Sorted unique labels per example: [[label, ...], ...]."""
    return [
        sorted(set(to_list(example.get(label_key) or [])))
        for example in dataset
    ]


def rebalance_repeats(labels_per_example, *, source_weight=1,
                      counts=None, min_counts=None):
    """Per-example repeat counts so every class reaches a minimum number
    of occurrences per epoch.

    Semantics follow the reference contract
    (``provider.py:217-279``): given per-class occurrence counts over the
    whole (already repeat-weighted) training set, a float ``min_counts``
    is a fraction of the most frequent class; a base repetition factor
    blows the epoch up just enough that the requested minimum stays below
    the (unrepeated) maximum, then each example is repeated by the
    largest per-label factor among its labels.

    Args:
        labels_per_example: [[label, ...], ...] for ONE source.
        source_weight: the source's repeat factor in the epoch spec.
        counts: {label: count} over ALL sources (weighted); computed from
            ``labels_per_example`` alone when None.
        min_counts: int (absolute) or float in (0, 1) (fraction of the
            max class count).

    Returns: (repeats (N,) int array for this source, label_repetitions).
    """
    if counts is None:
        counts = {}
        for labels in labels_per_example:
            for label in labels:
                counts[label] = counts.get(label, 0) + source_weight
    peak = max(counts.values())
    if isinstance(min_counts, float):
        assert 0. < min_counts < 1., min_counts
        min_counts = math.ceil(peak * min_counts)
    assert isinstance(min_counts, int) and min_counts > 1, min_counts
    assert min_counts - 1 <= 0.9 * peak, (min_counts, peak)
    base = int(1 // (1 - (min_counts - 1) / peak))
    target = min_counts * base
    label_reps = {
        label: math.ceil(target / count) for label, count in counts.items()
    }
    reps = np.array([
        max((label_reps[label] for label in labels), default=1)
        for labels in labels_per_example
    ], dtype=np.int64)
    return reps, label_reps


@dataclasses.dataclass
class EpochPlan:
    """Index-level composition of one training epoch.

    ``streams`` is a list of (dataset, tile_factor) pairs; iterating the
    plan reshuffles each stream and interleaves them proportionally to
    their lengths (round-robin by progress), the reference's
    tile + intersperse contract expressed over explicit index groups.
    """
    streams: list

    @classmethod
    def build(cls, sources, repeats_per_source=None):
        """Args:
            sources: [(dataset, tile_factor), ...].
            repeats_per_source: optional per-source (N,) per-example
                repeat arrays (from :func:`rebalance_repeats`); examples
                with equal repeat count form one tiled index group, so a
                plan stays a small list of (indexable view, tiles).
        """
        streams = []
        for i, (dataset, tiles) in enumerate(sources):
            reps = None if repeats_per_source is None \
                else repeats_per_source[i]
            if reps is None:
                streams.append((dataset, tiles))
                continue
            for factor in np.unique(reps):
                members = np.flatnonzero(reps == factor).tolist()
                streams.append((dataset[members], int(factor) * tiles))
        return cls(streams)

    def materialize(self, shuffle, seed=None):
        """``seed`` makes every per-source reshuffle deterministic (one
        derived stream per source) — REQUIRED for batch-level multi-host
        sharding, where every host must assemble the identical epoch."""
        parts = []
        for idx, (dataset, tiles) in enumerate(self.streams):
            if shuffle:
                rng = (np.random.RandomState(seed + idx)
                       if seed is not None else None)
                dataset = dataset.shuffle(reshuffle=True, rng=rng)
            parts.append(dataset.tile(tiles))
        return lazy.intersperse(*parts)


@dataclasses.dataclass
class DataProvider(Configurable):
    json_path: str = None
    audio_reader: Callable = None
    train_set: dict = None
    validate_set: str = None
    cached_datasets: list = None
    min_audio_length: float = 1.
    train_segmenter: Callable = None
    test_segmenter: Callable = None
    train_transform: Callable = None
    test_transform: Callable = None
    train_fetcher: Callable = None
    test_fetcher: Callable = None
    label_key: str = 'events'
    discard_labelless_train_examples: bool = True
    storage_dir: str = None
    # disk-backed decode cache root (data/cache.py MemmapAudioCache):
    # when set, datasets listed in ``cached_datasets`` are decoded ONCE
    # into a per-dataset waveform memmap under ``cache_dir/<name>`` and
    # memmap-read afterwards (across processes/runs) instead of being
    # eagerly re-decoded into RAM per process. Augmentation randomness
    # stays live — the cache sits at the same pipeline position as the
    # reference's eager ``.cache()`` (provider.py:119-126).
    cache_dir: str = None
    # augmentation
    min_class_examples_per_epoch: float = 0
    scale_sampling_fn: Callable = None
    mix_interval: float = 1.5
    mix_fn: Callable = None
    # multi-host knobs: seed for the per-source epoch reshuffles
    # (batch-level sharding needs identical epochs on every host), and
    # an optional (num_shards, shard_index) pre-DECODE shard filter by
    # clip-id hash (the path for decode-bound corpora — the fetcher's
    # example-level sharding runs after the audio map)
    epoch_shuffle_seed: int = None
    raw_shard: tuple = None
    # wav decode on an ordered thread pool (lazy.ParallelMapDataset):
    # the decode draws no randomness, so the stream stays bit-identical
    # to the sequential map. 0/1 = sequential.
    decode_workers: int = 0

    def __post_init__(self):
        assert self.json_path is not None, 'json_path required'
        self.db = JsonDatabase(json_path=self.json_path)

    # ------------------------------------------------------------------
    # public API (reference surface)
    # ------------------------------------------------------------------
    def get_train_set(self, filter_example_ids=None):
        return self.get_dataset(self.train_set, train=True,
                                filter_example_ids=filter_example_ids)

    def get_validate_set(self, filter_example_ids=None):
        if self.validate_set is None:
            return None
        return self.get_dataset(self.validate_set, train=False,
                                filter_example_ids=filter_example_ids)

    def get_dataset(self, names_or_datasets, train=False,
                    filter_example_ids=None):
        audio = self.prepare_audio(
            names_or_datasets, train=train,
            filter_example_ids=filter_example_ids)
        return self.segment_transform_and_fetch(audio, train=train)

    def get_raw(self, names_or_datasets, discard_labelless_examples=False,
                filter_example_ids=None):
        """One filtered raw Dataset (str/Dataset input) or a list of
        (Dataset, repeats) (dict/list input) — the reference's polymorphic
        raw accessor."""
        spec = self._source_spec(names_or_datasets)
        if spec is not None:
            return [
                (self.get_raw(
                    source, discard_labelless_examples,
                    filter_example_ids), tiles)
                for source, tiles in spec
            ]
        dataset = (self.db.get_dataset(names_or_datasets)
                   if isinstance(names_or_datasets, str)
                   else names_or_datasets)
        keep = self._example_filter(
            discard_labelless_examples, filter_example_ids)
        dataset = dataset.filter(keep, lazy=False)
        if self.raw_shard is not None:
            # pre-DECODE shard membership by clip-id hash, applied at the
            # single raw choke point so every consumer (audio decode,
            # label counting for rebalancing, epoch plans) sees the SAME
            # filtered index space; eager filter keeps it indexable
            import zlib
            num_shards, shard_index = self.raw_shard
            dataset = dataset.filter(
                lambda ex: zlib.crc32(
                    str(ex['example_id']).encode()) % num_shards
                == shard_index,
                lazy=False)
        return dataset

    # ------------------------------------------------------------------
    # plan construction
    # ------------------------------------------------------------------
    @staticmethod
    def _source_spec(names_or_datasets):
        """dict/list input -> [(name_or_dataset, tiles), ...] with zero-
        repeat sources dropped; None for a single-source input."""
        if isinstance(names_or_datasets, dict):
            items = list(names_or_datasets.items())
        elif isinstance(names_or_datasets, (list, tuple)):
            items = [x if isinstance(x, (list, tuple)) else (x, 1)
                     for x in names_or_datasets]
        else:
            return None
        return [(source, tiles) for source, tiles in items if tiles > 0]

    def _example_filter(self, discard_labelless, filter_example_ids):
        label_key = self.label_key
        min_length = self.min_audio_length
        excluded = (None if filter_example_ids is None
                    else set(filter_example_ids))

        def keep(example):
            if discard_labelless and not example.get(label_key):
                return False
            if excluded is not None and example['example_id'] in excluded:
                return False
            return example.get('audio_length', 0) > min_length

        return keep

    def _decode(self, raw, name=None):
        """Raw -> decoded-audio dataset (+ optional eager/disk cache)."""
        decoded = raw.map(self.audio_reader,
                          num_workers=self.decode_workers)
        if name is not None:
            if name in (self.cached_datasets or ()):
                if self.cache_dir is not None:
                    from pb_sed_tpu_torch.data.cache import MemmapAudioCache
                    import pathlib
                    import zlib
                    ids_crc = 0
                    for ex in raw:
                        ids_crc = zlib.crc32(
                            str(ex['example_id']).encode(), ids_crc)
                    fingerprint = (
                        name, len(raw), ids_crc,
                        int(self.audio_reader.target_sample_rate),
                    )
                    decoded = MemmapAudioCache.wrap(
                        decoded,
                        pathlib.Path(self.cache_dir) / name,
                        fingerprint)
                else:
                    decoded = decoded.cache(lazy=False)
            print(f'Single data set length {name}:', len(decoded))
        else:
            print('Single data set length:', len(decoded))
        return decoded

    def _audio_source(self, name_or_dataset, train, filter_example_ids):
        raw = self.get_raw(
            name_or_dataset,
            discard_labelless_examples=(
                train and self.discard_labelless_train_examples),
            filter_example_ids=filter_example_ids,
        )
        return self._decode(
            raw, name_or_dataset
            if isinstance(name_or_dataset, str) else None)

    def _train_plan(self, spec, filter_example_ids):
        """Epoch plan over the train sources: per-source raw datasets are
        materialized ONCE and feed BOTH the audio decode map and the
        label-count rebalancing pass, so the per-example repeat indices
        always address the same (possibly raw_shard-filtered) space."""
        raw_sources = [
            (self.get_raw(
                source,
                discard_labelless_examples=(
                    self.discard_labelless_train_examples),
                filter_example_ids=filter_example_ids), source, tiles)
            for source, tiles in spec
        ]
        sources = [
            (self._decode(
                raw, source if isinstance(source, str) else None), tiles)
            for raw, source, tiles in raw_sources
        ]
        if not self.min_class_examples_per_epoch:
            return EpochPlan.build(sources)
        # class occurrence counts over the whole weighted epoch
        per_source_labels = [
            example_labels(raw, self.label_key)
            for raw, *_ in raw_sources
        ]
        counts = {}
        for labels_list, (*_, tiles) in zip(per_source_labels,
                                            raw_sources):
            for labels in labels_list:
                for label in labels:
                    counts[label] = counts.get(label, 0) + tiles
        repeats = [
            rebalance_repeats(
                labels_list, counts=counts,
                min_counts=self.min_class_examples_per_epoch)[0]
            for labels_list in per_source_labels
        ]
        return EpochPlan.build(sources, repeats_per_source=repeats)

    def prepare_audio(self, names_or_datasets, train=False,
                      filter_example_ids=None):
        """Decoded, (re)balanced, interleaved and augmented audio stream."""
        spec = self._source_spec(names_or_datasets)
        if spec is None:
            spec = [(names_or_datasets, 1)]
        if train:
            plan = self._train_plan(spec, filter_example_ids)
            stream = plan.materialize(
                shuffle=True, seed=self.epoch_shuffle_seed)
            stream = self._augment(stream)
        else:
            plan = EpochPlan.build([
                (self._audio_source(source, False, filter_example_ids),
                 tiles)
                for source, tiles in spec
            ])
            stream = plan.materialize(shuffle=False)
        print('Total data set length:', len(stream))
        return stream

    # ------------------------------------------------------------------
    # augmentation
    # ------------------------------------------------------------------
    def _augment(self, stream):
        """Random gain + every-``mix_interval``-th superposition mixing
        (the mixin stream is the scaled stream itself, reference
        ``scale_and_mix``)."""
        if self.epoch_shuffle_seed is not None:
            # the host-identical-epoch contract (batch-level multi-host
            # sharding) extends to the augmentation draws: re-seed the
            # samplers' rngs deterministically
            for offset, fn in ((9001, self.scale_sampling_fn),
                               (9002, self.mix_fn)):
                if fn is not None and hasattr(fn, 'rng'):
                    fn.rng = np.random.RandomState(
                        self.epoch_shuffle_seed + offset)
        if self.scale_sampling_fn is not None:
            draw_scale = self.scale_sampling_fn

            def apply_gain(example):
                out = dict(example)
                out['audio_data'] = out['audio_data'] * float(draw_scale())
                return out

            stream = stream.map(apply_gain)
        if self.mix_interval is not None:
            assert self.mix_fn is not None, 'mix_interval without mix_fn'
            stream = MixtureDataset(
                stream, stream, mix_interval=self.mix_interval,
                mix_fn=self.mix_fn)
        return stream

    # ------------------------------------------------------------------
    # transform + fetch
    # ------------------------------------------------------------------
    def segment_transform_and_fetch(self, dataset, segment=True,
                                    transform=True, fetch=True,
                                    train=False):
        segmenter = self.train_segmenter if train else self.test_segmenter
        segmented = segment and segmenter is not None
        if segmented:
            dataset = dataset.map(segmenter)
        if transform:
            transform_fn = (self.train_transform if train
                            else self.test_transform)
            assert transform_fn is not None, 'transform required'
            dataset = (dataset.batch_map(transform_fn) if segmented
                       else dataset.map(transform_fn))
        if fetch:
            fetcher = self.train_fetcher if train else self.test_fetcher
            assert fetcher is not None, 'fetcher required'
            dataset = fetcher(dataset, batched_input=segmented)
        return dataset

    # ------------------------------------------------------------------
    # dogmatic defaults (reference provider.py:302-378 contract)
    # ------------------------------------------------------------------
    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['audio_reader'] = dict(
            factory=AudioReader, source_sample_rate=None,
            target_sample_rate=16000, average_channels=True,
            normalization_domain='instance', normalization_type='max',
            alignment_keys=['events'],
        )
        stft_spec = dict(
            factory=STFT, shift=320, window_length=960, size=1024,
            fading='half', pad=True,
        )
        config['train_transform'] = dict(
            factory=Transform,
            stft=stft_spec,
            label_encoder=dict(
                factory=MultiHotAlignmentEncoder, label_key='events',
                storage_dir=config['storage_dir'],
            ),
            # time-warp anchors: U(.4,.6) of the clip moved by U(-.1,.1)
            anchor_sampling_fn=dict(factory=Uniform, low=0.4, high=0.6),
            anchor_shift_sampling_fn=dict(
                factory=Uniform, low=-0.1, high=0.1),
        )
        config['test_transform'] = dict(
            factory=Transform,
            stft=config['train_transform']['stft'].to_dict(),
            label_encoder=(
                config['train_transform']['label_encoder'].to_dict()),
            provide_boundary_targets=(
                config['train_transform']['provide_boundary_targets']),
            provide_strong_targets=(
                config['train_transform']['provide_strong_targets']),
        )
        config['train_fetcher'] = dict(
            factory=DataFetcher, prefetch_workers=2, batch_size=16,
            max_padding_rate=.05, pad_to_multiple=64,
            max_bucket_buffer_size=2000, drop_incomplete=True,
            global_shuffle=False,
            stft=config['train_transform']['stft'].to_dict(),
        )
        train_fetcher = config['train_fetcher']
        config['test_fetcher'] = dict(
            factory=DataFetcher,
            prefetch_workers=train_fetcher['prefetch_workers'],
            batch_size=2 * train_fetcher['batch_size'],
            max_padding_rate=train_fetcher['max_padding_rate'],
            pad_to_multiple=train_fetcher['pad_to_multiple'],
            bucket_expiration=train_fetcher['bucket_expiration'],
            max_bucket_buffer_size=(
                train_fetcher['max_bucket_buffer_size']),
            drop_incomplete=False, global_shuffle=False,
            stft=config['train_transform']['stft'].to_dict(),
        )
        # gain augmentation: log-truncnormal scale, truncation ln 3
        config['scale_sampling_fn'] = dict(
            factory=LogTruncatedNormal, loc=0., scale=1.,
            truncation=float(np.log(3.)),
        )
        if config['mix_interval'] is not None:
            config['mix_fn'] = dict(
                factory=SuperposeEvents, min_overlap=1.,
                fade_length=(
                    config['train_transform']['stft']['window_length']),
                label_key='events',
            )
