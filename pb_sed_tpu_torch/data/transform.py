"""Per-example featurization: label typing + target encoding + warp params.

Capability parity with ``pb_sed/data_preparation/transform.py:10-128`` and
``utils.py:3-31`` (``add_label_types``): weak targets with **0.5 soft value
for unlabeled examples**, boundary targets (union span per class) and/or
strong targets (K, T) with 0.5 fill driven by the clip-level multi-hot, and
random time warping.

The reference ran the STFT here on CPU workers; this transform only
computes the *geometry* (sample -> frame alignment via ops/stft.py) and
ships the raw waveform: the STFT itself runs on the device in the model.
Time-warp parameters are sampled here (host RNG) so targets and the
device-side warped framing stay consistent
(reference ``TimeWarpedSTFT``, ``transform.py:36-47``).
"""
import dataclasses
from typing import Callable

import numpy as np

from pb_sed_tpu_torch.data.encoder import MultiHotAlignmentEncoder
from pb_sed_tpu_torch.ops.stft import STFT, warp_sample_position
from pb_sed_tpu_torch.utils.config import Configurable


def add_label_types(example):
    """Infer weak/strong/unlabeled labeling (reference ``utils.py:3-31``)."""
    if ('events_start_samples' in example
            or 'events_stop_samples' in example):
        assert ('events' in example
                and 'events_start_samples' in example
                and 'events_stop_samples' in example), example.keys()
        example.setdefault(
            'label_types', len(example['events']) * ['strong'])
        example.setdefault('unlabeled', False)
    elif 'events' in example:
        example['events_start_samples'] = [0] * len(example['events'])
        example['events_stop_samples'] = [
            example['audio_data'].shape[-1]] * len(example['events'])
        example.setdefault('label_types', len(example['events']) * ['weak'])
        example.setdefault('unlabeled', False)
    else:
        example['events'] = []
        example['events_start_samples'] = []
        example['events_stop_samples'] = []
        example['label_types'] = []
        example['unlabeled'] = True
    return example


@dataclasses.dataclass
class Transform(Configurable):
    stft: STFT = None
    label_encoder: MultiHotAlignmentEncoder = None
    provide_boundary_targets: bool = False
    provide_strong_targets: bool = False
    pop_audio_data: bool = False  # kept False: the waveform IS the input
    # augmentation (time warp)
    anchor_sampling_fn: Callable = None
    anchor_shift_sampling_fn: Callable = None

    def __post_init__(self):
        if isinstance(self.stft, dict):
            cfg = dict(self.stft)
            cfg.pop('factory', None)
            self.stft = STFT(**cfg)
        assert isinstance(self.stft, STFT), type(self.stft)

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['stft'] = {'factory': STFT}
        config['label_encoder'] = {'factory': MultiHotAlignmentEncoder}

    def __call__(self, example):
        example = add_label_types(dict(example))
        label_types = example.pop('label_types')
        unlabeled = example.pop('unlabeled')
        audio = example['audio_data']
        if audio.ndim == 2:
            audio = audio[0]
        num_samples = audio.shape[-1]
        seq_len = self.stft.num_frames(num_samples)
        enc = self.label_encoder

        warp = None
        if self.anchor_shift_sampling_fn is not None:
            assert callable(self.anchor_sampling_fn)
            from pb_sed_tpu_torch.ops.stft import sample_time_warp
            warp = sample_time_warp(
                num_samples, self.anchor_sampling_fn,
                self.anchor_shift_sampling_fn)

        def to_frames(samples, kind):
            samples = np.asarray(samples, dtype=float)
            if warp is not None and len(samples):
                samples = warp_sample_position(
                    samples, warp[0], warp[1], num_samples)
            if kind == 'start':
                return self.stft.sample_to_onset_frame(samples).astype(int)
            return np.clip(
                self.stft.sample_to_offset_frame(samples), 0, seq_len
            ).astype(int)

        start_frames = to_frames(example['events_start_samples'], 'start')
        stop_frames = to_frames(example['events_stop_samples'], 'stop')

        weak_targets = enc.encode_multi_hot(example['events'])
        if unlabeled:
            weak_targets = weak_targets + (1. - weak_targets) * 0.5

        out = {
            'dataset': example.get('dataset', ''),
            'example_id': example.get('example_id', ''),
            'audio_data': np.asarray(audio, dtype=np.float32),
            'seq_len': int(seq_len),
            'seq_len_samples': int(num_samples),
            'weak_targets': weak_targets,
        }
        if warp is not None:
            out['warp_anchor_out'] = np.float32(warp[0])
            out['warp_anchor_in'] = np.float32(warp[1])

        if self.provide_boundary_targets or self.provide_strong_targets:
            # frame alignment of ALL events (weak events span the whole
            # clip via add_label_types): the 0.5 fill only marks frames
            # where an event of that class MIGHT be; frames outside any
            # occurrence stay certain negatives
            overall = enc.encode_alignment(
                [(int(start_frames[i]), int(stop_frames[i]),
                  enc.encode(label))
                 for i, label in enumerate(example['events'])],
                seq_len)  # (T, K)
            if self.provide_boundary_targets:
                spans = {}
                for i, label in enumerate(example['events']):
                    if label_types[i] not in ('boundaries', 'strong'):
                        continue
                    lo, hi = int(start_frames[i]), int(stop_frames[i])
                    if label in spans:
                        spans[label] = (min(spans[label][0], lo),
                                        max(spans[label][1], hi))
                    else:
                        spans[label] = (lo, hi)
                aligned = enc.encode_alignment(
                    [(lo, hi, enc.encode(lb))
                     for lb, (lo, hi) in spans.items()], seq_len)
                if unlabeled:
                    aligned = aligned + (1. - aligned) * 0.5
                else:
                    aligned = aligned + (1. - aligned) * 0.5 * overall
                out['boundary_targets'] = aligned.T  # (K, T)
            if self.provide_strong_targets:
                aligned = enc.encode_alignment(
                    [(int(start_frames[i]), int(stop_frames[i]),
                      enc.encode(label))
                     for i, label in enumerate(example['events'])
                     if label_types[i] == 'strong'], seq_len)
                if unlabeled:
                    aligned = aligned + (1. - aligned) * 0.5
                else:
                    aligned = aligned + (1. - aligned) * 0.5 * overall
                out['strong_targets'] = aligned.T  # (K, T)
        if self.pop_audio_data:
            out.pop('audio_data')
        return out
