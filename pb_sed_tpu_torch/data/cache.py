"""Disk-backed feature caching: decode the corpus ONCE, memmap forever.

Capability parity with the reference's eager decode cache
(``pb_sed/data_preparation/provider.py:119-126`` — ``.cache()`` over the
AudioReader map), extended disk-backed so the decode + resample +
peak-normalize work is paid once per corpus, not once per process, and
a single-core host can feed the chip (VERDICT r4 #6). Two caches:

- :class:`MemmapAudioCache` — per-dataset decode cache. Waveforms live
  in one contiguous float32 memmap; everything else (labels, alignment
  samples, seq_len) in a JSON index. Reads are zero-copy memmap views,
  so augmentation randomness (gain, superposition mixing, time-warp
  anchors) stays LIVE downstream — semantically identical to the
  in-RAM ``cached_datasets`` path.
- :class:`BatchCache` — palette-shaped collated batches (the
  DataFetcher output) stored verbatim. Replay is exact wherever the
  pipeline draws no randomness (validation / inference, or training
  with augmentation disabled); training WITH augmentation should use
  the audio cache instead so the draws differ per epoch.
"""
import json
import os
from pathlib import Path

import numpy as np

from pb_sed_tpu_torch.data import lazy

_VERSION = 1
_ALIGN = 64  # byte alignment of blob records


def _jsonable(value):
    """Recursively convert numpy scalars/arrays for the JSON index."""
    if isinstance(value, np.ndarray):
        return {'__ndarray__': value.tolist(), 'dtype': str(value.dtype)}
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return value


def _unjsonable(value):
    if isinstance(value, dict):
        if '__ndarray__' in value:
            return np.asarray(value['__ndarray__'], dtype=value['dtype'])
        return {k: _unjsonable(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unjsonable(v) for v in value]
    return value


class _CachedAudioDataset(lazy.Dataset):
    """Indexable view over a built MemmapAudioCache."""

    def __init__(self, meta, offsets, lengths, blob_path):
        self._meta = meta
        self._offsets = offsets
        self._lengths = lengths
        self._blob_path = str(blob_path)
        self._mm = None

    def __len__(self):
        return len(self._meta)

    def __getitem__(self, item):
        if not isinstance(item, (int, np.integer)):
            return super().__getitem__(item)
        if self._mm is None:
            # opened lazily so the dataset object stays picklable for
            # prefetch workers; the OS page cache shares the pages
            self._mm = np.memmap(self._blob_path, np.float32, mode='r')
        example = dict(self._meta[item])
        o, n = self._offsets[item], self._lengths[item]
        example['audio_data'] = self._mm[o:o + n][None, :]
        return example


class MemmapAudioCache:
    """One contiguous float32 waveform blob + JSON metadata index.

    ``fingerprint`` ties a cache directory to the exact filtered
    example set that built it (dataset length + first/last example id +
    sample rate); a mismatch triggers a rebuild, never a silent stale
    read.
    """

    def __init__(self, cache_dir):
        self.cache_dir = Path(cache_dir)
        self.blob_path = self.cache_dir / 'audio_f32.bin'
        self.index_path = self.cache_dir / 'index.json'

    # -- state ---------------------------------------------------------
    def load_index(self):
        if not (self.blob_path.exists() and self.index_path.exists()):
            return None
        with open(self.index_path) as fid:
            index = json.load(fid)
        if index.get('version') != _VERSION:
            return None
        return index

    def valid(self, fingerprint):
        index = self.load_index()
        return (index is not None
                and index.get('fingerprint') == list(fingerprint))

    # -- build / open ----------------------------------------------------
    def build(self, decoded, fingerprint):
        """Iterates a decoded-audio dataset once, writing the cache.

        Atomic-ish: the index is written LAST, so an interrupted build
        leaves an invalid (index-less) directory that the next run
        rebuilds."""
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        meta, offsets, lengths = [], [], []
        offset = 0
        with open(self.blob_path, 'wb') as blob:
            for example in decoded:
                example = dict(example)
                audio = np.ascontiguousarray(
                    example.pop('audio_data'), dtype=np.float32)
                assert audio.ndim == 2 and audio.shape[0] == 1, audio.shape
                blob.write(audio.tobytes())
                offsets.append(offset)
                lengths.append(audio.shape[-1])
                offset += audio.shape[-1]
                meta.append(_jsonable(example))
        index = {
            'version': _VERSION,
            'fingerprint': list(fingerprint),
            'offsets': offsets,
            'lengths': lengths,
            'meta': meta,
        }
        tmp = self.index_path.with_suffix('.json.tmp')
        with open(tmp, 'w') as fid:
            json.dump(index, fid)
        os.replace(tmp, self.index_path)

    def dataset(self):
        index = self.load_index()
        assert index is not None, f'no valid cache at {self.cache_dir}'
        meta = [_unjsonable(m) for m in index['meta']]
        return _CachedAudioDataset(
            meta, index['offsets'], index['lengths'], self.blob_path)

    @classmethod
    def wrap(cls, decoded, cache_dir, fingerprint):
        """Open-or-build: returns a memmap-backed dataset equivalent to
        ``decoded`` (the provider's single call site)."""
        cache = cls(cache_dir)
        if not cache.valid(fingerprint):
            cache.build(decoded, fingerprint)
        return cache.dataset()


# ----------------------------------------------------------------------
# collated-batch cache
# ----------------------------------------------------------------------
class _CachedBatchDataset(lazy.Dataset):
    def __init__(self, manifest, blob_path):
        self._manifest = manifest
        self._blob_path = str(blob_path)
        self._mm = None

    def __len__(self):
        return len(self._manifest)

    def __getitem__(self, item):
        if not isinstance(item, (int, np.integer)):
            return super().__getitem__(item)
        if self._mm is None:
            self._mm = np.memmap(self._blob_path, np.uint8, mode='r')
        batch = {}
        for key, spec in self._manifest[item].items():
            if 'host' in spec:
                batch[key] = list(spec['host'])
            else:
                nbytes = int(np.dtype(spec['dtype']).itemsize
                             * np.prod(spec['shape'], dtype=np.int64))
                raw = self._mm[spec['offset']:spec['offset'] + nbytes]
                batch[key] = raw.view(spec['dtype']).reshape(spec['shape'])
        return batch


class BatchCache:
    """Palette-shaped collated batches memmapped verbatim.

    The write path streams whatever the fetcher yields — each array
    value is recorded (dtype, shape, offset) into one uint8 blob, host
    lists (``example_id``/``dataset``) go into the JSON manifest. The
    replay dataset is indexable, so epoch-order shuffling composes via
    ``.shuffle(reshuffle=True)`` without touching the blob."""

    def __init__(self, cache_dir):
        self.cache_dir = Path(cache_dir)
        self.blob_path = self.cache_dir / 'batches.bin'
        self.manifest_path = self.cache_dir / 'manifest.json'

    def exists(self):
        return self.blob_path.exists() and self.manifest_path.exists()

    def build(self, batches):
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        manifest = []
        offset = 0
        with open(self.blob_path, 'wb') as blob:
            for batch in batches:
                entry = {}
                for key, value in batch.items():
                    if isinstance(value, np.ndarray):
                        value = np.ascontiguousarray(value)
                        pad = (-offset) % _ALIGN
                        if pad:
                            blob.write(b'\0' * pad)
                            offset += pad
                        entry[key] = {
                            'dtype': str(value.dtype),
                            'shape': list(value.shape),
                            'offset': offset,
                        }
                        blob.write(value.tobytes())
                        offset += value.nbytes
                    else:
                        entry[key] = {'host': _jsonable(value)}
                manifest.append(entry)
        tmp = self.manifest_path.with_suffix('.json.tmp')
        with open(tmp, 'w') as fid:
            json.dump({'version': _VERSION, 'batches': manifest}, fid)
        os.replace(tmp, self.manifest_path)
        return self.dataset()

    def dataset(self):
        with open(self.manifest_path) as fid:
            manifest = json.load(fid)
        assert manifest.get('version') == _VERSION
        return _CachedBatchDataset(manifest['batches'], self.blob_path)
