"""Waveform-domain mixture augmentation.

Capability parity with ``pb_sed/data_preparation/mix.py:7-156``:
``MixtureDataset`` mixes every ``mix_interval``-th example with the next
mixin example (interval 1.5 -> 2/3 of examples mixed);
``SuperposeEvents`` superimposes two clips at a random offset subject to a
``min_overlap`` constraint, applies raised-cosine fades at cut edges,
shifts event sample times, unions labels/label_types and joins ids with
'+'.
"""
import numbers

import numpy as np

from pb_sed_tpu_torch.data.lazy import Dataset
from pb_sed_tpu_torch.data.transform import add_label_types
from pb_sed_tpu_torch.utils.config import Configurable


class MixtureDataset(Dataset):
    def __init__(self, input_dataset, mixin_dataset, mix_interval, mix_fn):
        assert len(mixin_dataset) >= len(input_dataset), (
            len(mixin_dataset), len(input_dataset))
        assert mix_interval >= 1
        self.input_dataset = input_dataset
        self.mixin_dataset = mixin_dataset
        self.mix_interval = mix_interval
        self.mix_fn = mix_fn

    def __len__(self):
        return len(self.input_dataset)

    def __getitem__(self, item):
        if isinstance(item, numbers.Integral):
            example = self.input_dataset[item]
            if (item % self.mix_interval) < 1:
                mixin = self.mixin_dataset[int(item // self.mix_interval)]
                return self.mix_fn([example, mixin])
            return example
        return super().__getitem__(item)

    def __iter__(self):
        mixin_iter = iter(self.mixin_dataset)
        for i, example in enumerate(self.input_dataset):
            if (i % self.mix_interval) < 1:
                yield self.mix_fn([example, next(mixin_iter)])
            else:
                yield example

    def copy(self, freeze=False):
        return MixtureDataset(
            self.input_dataset.copy(freeze), self.mixin_dataset.copy(freeze),
            self.mix_interval, self.mix_fn)

    @property
    def indexable(self):
        return self.input_dataset.indexable


class SuperposeEvents(Configurable):
    """Additive superposition with random offset and edge fades."""

    def __init__(self, min_overlap=1., max_length_in_samples=None,
                 fade_length=0, label_key='events', rng=None):
        self.min_overlap = min_overlap
        self.max_length_in_samples = max_length_in_samples
        self.fade_length = fade_length
        self.label_key = label_key
        self.rng = rng or np.random

    def __call__(self, components):
        assert len(components) > 0
        components = [add_label_types(dict(c)) for c in components]
        base_len = components[0]['audio_data'].shape[-1]
        starts = [0]
        stops = [base_len]
        for comp in components[1:]:
            seq_len = comp['audio_data'].shape[-1]
            min_ov = int(np.ceil(min(seq_len, base_len) * self.min_overlap))
            lo = -(seq_len - min_ov)
            hi = base_len - min_ov
            if self.max_length_in_samples is not None:
                assert seq_len <= self.max_length_in_samples
                lo = max(lo, max(stops) - self.max_length_in_samples)
                hi = min(hi, min(starts)
                         + self.max_length_in_samples - seq_len)
            start = int(np.floor(lo + self.rng.rand() * (hi - lo + 1)))
            starts.append(start)
            stops.append(start + seq_len)
        starts = np.array(starts)
        stops = np.array(stops)
        shift = starts.min()
        starts -= shift
        stops -= shift

        first = components[0]['audio_data']
        mixed_shape = list(np.shape(first))
        mixed_shape[-1] = int(stops.max())
        mixed = np.zeros(mixed_shape, dtype=np.float32)
        events, label_types = [], []
        ev_starts, ev_stops = [], []
        for comp, start, stop in zip(components, starts, stops):
            audio = np.array(comp['audio_data'], dtype=np.float32)
            fl = self.fade_length
            if fl > 0:
                assert audio.shape[-1] > 2 * fl, audio.shape
                fade = 0.5 + np.cos(
                    np.pi * np.arange(1, fl + 1) / (fl + 1)) / 2
                if start > 0:
                    audio[..., :fl] *= fade[::-1]
                if stop < mixed_shape[-1]:
                    audio[..., -fl:] *= fade
            mixed[..., start:stop] += audio
            events.extend(comp[self.label_key])
            label_types.extend(comp['label_types'])
            ev_starts.extend(
                s + start for s in comp[f'{self.label_key}_start_samples'])
            ev_stops.extend(
                s + start for s in comp[f'{self.label_key}_stop_samples'])

        return {
            'example_id': '+'.join(c['example_id'] for c in components),
            'dataset': '+'.join(sorted(
                {c.get('dataset', '') for c in components})),
            'audio_data': mixed,
            'seq_len': mixed.shape[-1],
            self.label_key: events,
            f'{self.label_key}_start_samples': ev_starts,
            f'{self.label_key}_stop_samples': ev_stops,
            'label_types': label_types,
            'unlabeled': any(c['unlabeled'] for c in components),
        }
