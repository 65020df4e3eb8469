"""Long-audio chunked inference: split batches into overlapping segments
and stitch per-clip score arrays back together.

Capability parity with ``pb_sed/utils/segment.py:7-71``: segments are
tagged ``<id>_!segment!_<i>_<n>``; ``merge_segments`` trims half the
overlap from interior edges before concatenating along time.

Works on the waveform-input batches of this framework (key 'audio_data',
sample domain) as well as on precomputed 'stft' batches (frame domain).

The port's own copy of ``pb_sed_tpu/utils/segment.py``: the port imports
nothing of the JAX package. Keep the two in step.
"""
from math import ceil

import numpy as np


def segment_batch(batch, max_length, overlap, keys=None, stft=None):
    """Split a batch along time into overlapping segments.

    Args:
        batch: collated batch dict.
        max_length: maximum segment length in FRAMES.
        overlap: overlap between segments in FRAMES.
        keys: keys to segment; defaults to ('audio_data',) or ('stft',).
        stft: STFT geometry (required for waveform batches to convert the
            frame-domain max_length/overlap to samples).

    Returns: list of segment batches.
    """
    seq_lens = np.asarray(batch['seq_len'])
    if seq_lens.max() <= max_length:
        return [batch]
    if keys is None:
        keys = ('audio_data',) if 'audio_data' in batch else ('stft',)
    shift = max_length - overlap
    n_segments = int(ceil((seq_lens.max() - max_length) / shift) + 1)
    print(f'Split batch with sequence length {seq_lens.max()} into '
          f'{n_segments} segments.')
    segments = []
    for i in range(n_segments):
        start_frame = i * shift
        seg = {}
        for key, value in batch.items():
            if key in keys:
                if key == 'audio_data':
                    assert stft is not None, 'need STFT geometry'
                    start = start_frame * stft.shift
                    length = stft.num_samples_for_frames(max_length)
                    seg[key] = _slice_pad(value, start, length)
                else:
                    seg[key] = _slice_pad(value, start_frame, max_length,
                                          axis=1)
            elif key == 'example_id':
                seg[key] = [
                    f'{ex_id}_!segment!_{i}_{n_segments}'
                    for ex_id in value]
            elif key == 'seq_len':
                seg[key] = np.asarray([
                    int(np.clip(sl - start_frame, 0, max_length))
                    for sl in seq_lens], dtype=np.int32)
            elif key == 'seq_len_samples':
                if stft is None:
                    seg[key] = value
                else:
                    start = start_frame * stft.shift
                    length = stft.num_samples_for_frames(max_length)
                    seg[key] = np.asarray([
                        int(np.clip(s - start, 0, length))
                        for s in np.asarray(value)], dtype=np.int32)
            elif key.endswith('_targets') and np.ndim(value) == 3:
                seg[key] = _slice_pad(value, start_frame, max_length,
                                      axis=-1)
            else:
                seg[key] = value
        segments.append(seg)
    return segments


def _slice_pad(arr, start, length, axis=-1):
    arr = np.asarray(arr)
    axis = axis % arr.ndim
    stop = min(start + length, arr.shape[axis])
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(start, stop)
    out = arr[tuple(sl)]
    pad = length - out.shape[axis]
    if pad > 0:
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        out = np.pad(out, widths)
    return out


def merge_segments(segmental_output, segment_overlap):
    """{segment_id: (..., T, K) score arr} -> {clip_id: merged arr}.

    Interior overlaps are split down the middle (left segment keeps
    ``shift + overlap//2`` frames, the right one starts at
    ``overlap//2``) — but CONTENT-aware: segment arrays are already
    sliced to each clip's true per-segment length, so a clip that ends
    inside a non-final segment keeps its trailing frames (and later
    empty/contained segments contribute nothing) instead of being
    silently truncated. Pooled outputs (time axis 1 per segment, e.g.
    clip tagging) merge by elementwise max.
    """
    merged = {}
    seg_lengths = [
        np.asarray(arr).shape[-2]
        for key, arr in segmental_output.items() if '_!segment!_' in key
    ]
    max_length = max(seg_lengths, default=0)
    pooled = max_length <= 1  # per-segment pooled scores (tagging)
    shift = max_length - segment_overlap
    half = segment_overlap // 2
    for audio_id in sorted(segmental_output.keys()):
        if '_!segment!_0_' in audio_id:
            clip_id, n_segments = audio_id.split('_!segment!_0_')
            n = int(n_segments)
            arrs = [
                np.asarray(
                    segmental_output[f'{clip_id}_!segment!_{i}_{n}'])
                for i in range(n)
            ]
            if pooled:
                merged[clip_id] = np.maximum.reduce(arrs)
                continue
            lens = [arr.shape[-2] for arr in arrs]
            parts = []
            for i, arr in enumerate(arrs):
                a = half if (i > 0 and segment_overlap > 0) else 0
                next_len = lens[i + 1] if i + 1 < n else 0
                if segment_overlap > 0 and next_len > half:
                    b = min(lens[i], shift + half)
                else:
                    b = lens[i]  # clip ends here: keep everything
                if b > a:
                    parts.append(arr[..., a:b, :])
            merged[clip_id] = np.concatenate(parts, axis=-2)
        elif '_!segment!_' not in audio_id:
            merged[audio_id] = segmental_output[audio_id]
    return merged
