"""Audio example segmentation for long-clip training
(capability of the ``train_segmenter`` / ``test_segmenter`` hooks in the
reference provider, ``pb_sed/data_preparation/provider.py:281-300``,
backed there by ``padertorch.data.segment.Segmenter``).

Splits one raw example into a list of fixed-length segments (samples
domain), re-anchoring event sample times per segment; the provider then
``batch_map``s the transform over the list and the fetcher unbatches.
"""
import dataclasses


from pb_sed_tpu_torch.utils.config import Configurable


@dataclasses.dataclass
class AudioSegmenter(Configurable):
    length: int = 160000          # samples per segment
    shift: int = None             # defaults to length (no overlap)
    label_key: str = 'events'
    include_incomplete: bool = True

    def __call__(self, example):
        shift = self.shift or self.length
        audio = example['audio_data']
        num_samples = audio.shape[-1]
        if num_samples <= self.length:
            return [example]
        starts = list(range(0, num_samples - self.length + shift, shift))
        segments = []
        for i, start in enumerate(starts):
            stop = min(start + self.length, num_samples)
            if stop - start < self.length and not self.include_incomplete:
                continue
            seg = {
                k: v for k, v in example.items()
                if not k.startswith(self.label_key) and k not in (
                    'audio_data', 'seq_len')
            }
            seg['example_id'] = (
                f"{example['example_id']}_!segment!_{i}_{len(starts)}")
            seg['audio_data'] = audio[..., start:stop]
            seg['seq_len'] = stop - start
            events, ev_starts, ev_stops, types = [], [], [], []
            labels = example.get(self.label_key, [])
            s_key = f'{self.label_key}_start_samples'
            p_key = f'{self.label_key}_stop_samples'
            for j, label in enumerate(labels):
                ev_start = example.get(s_key, [0] * len(labels))[j]
                ev_stop = example.get(
                    p_key, [num_samples] * len(labels))[j]
                if ev_stop <= start or ev_start >= stop:
                    continue
                events.append(label)
                ev_starts.append(max(ev_start - start, 0))
                ev_stops.append(min(ev_stop - start, stop - start))
                if 'label_types' in example:
                    types.append(example['label_types'][j])
            seg[self.label_key] = events
            seg[s_key] = ev_starts
            seg[p_key] = ev_stops
            if 'label_types' in example:
                seg['label_types'] = types
            segments.append(seg)
        return segments
