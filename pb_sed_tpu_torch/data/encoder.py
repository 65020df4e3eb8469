"""Multi-hot label <-> index encoding with frame alignment.

Capability parity with padertorch ``MultiHotAlignmentEncoder``
(``pb_sed/data_preparation/provider.py:323-327``,
``transform.py:56-62,107-124``): label vocabulary built from datasets and
persisted to ``storage_dir/events.json``; ``encode(label)`` -> index;
``encode_alignment([(start, stop, idx)], seq_len)`` -> (T, K) multi-hot;
``inverse_label_mapping``.
"""
import dataclasses
from pathlib import Path

import numpy as np

from pb_sed_tpu_torch.utils.config import Configurable
from pb_sed_tpu_torch.utils.misc import dump_json, load_json, to_list


@dataclasses.dataclass
class MultiHotAlignmentEncoder(Configurable):
    label_key: str = 'events'
    storage_dir: str = None

    def __post_init__(self):
        self.label_mapping = None

    @property
    def _storage_path(self):
        if self.storage_dir is None:
            return None
        return Path(self.storage_dir) / f'{self.label_key}.json'

    def initialize_labels(self, labels=None, dataset=None, verbose=False):
        """Build (or reload) the vocabulary.

        Like the reference: an existing persisted mapping wins; otherwise
        the vocabulary is collected from ``labels`` or by iterating
        ``dataset`` and persisted.
        """
        path = self._storage_path
        if path is not None and path.exists():
            stored = load_json(path)
            self.label_mapping = {
                label: idx for idx, label in enumerate(stored)}
            if verbose:
                print(f'Restored {len(stored)} labels from {path}')
            return
        vocab = set()
        if labels is not None:
            vocab.update(labels)
        if dataset is not None:
            for example in dataset:
                if self.label_key in example:
                    vocab.update(to_list(example[self.label_key]))
        assert vocab or path is not None, 'no labels found'
        ordered = sorted(vocab)
        self.label_mapping = {
            label: idx for idx, label in enumerate(ordered)}
        if path is not None and ordered:
            dump_json(ordered, path)
        if verbose:
            print(f'Initialized {len(ordered)} labels')

    @property
    def num_labels(self):
        assert self.label_mapping is not None, 'labels not initialized'
        return len(self.label_mapping)

    @property
    def inverse_label_mapping(self):
        return {idx: label for label, idx in self.label_mapping.items()}

    def encode(self, label):
        return self.label_mapping[label]

    def encode_alignment(self, labels, seq_len):
        """[(start_frame, stop_frame, class_idx)] -> (seq_len, K) multi-hot."""
        out = np.zeros((seq_len, self.num_labels), dtype=np.float32)
        for start, stop, idx in labels:
            start = int(max(start, 0))
            stop = int(min(stop, seq_len))
            if stop > start:
                out[start:stop, idx] = 1.
        return out

    def encode_multi_hot(self, labels):
        """List of label strings -> (K,) multi-hot."""
        out = np.zeros((self.num_labels,), dtype=np.float32)
        for label in to_list(labels):
            out[self.encode(label)] = 1.
        return out

    def __call__(self, example):
        """Returns ``{label_key: (K,) multi-hot}`` of all example labels."""
        return {self.label_key: self.encode_multi_hot(
            example.get(self.label_key, []))}
