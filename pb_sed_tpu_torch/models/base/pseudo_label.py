"""Pseudo-labeling: rewrite a dataset dict with model outputs.

Capability parity with ``pb_sed/models/base/pseudo_label.py:5-69``:
tags > 0.5 become weak labels; detected boundaries or events become
strong/boundary spans via ``set_onset_offset_times`` (classes tagged but
not detected get full-clip spans); prints label-rate statistics.

The port's own copy of ``pb_sed_tpu/models/base/pseudo_label.py``: the
port imports nothing of the JAX package. Keep the two in step.
"""
from copy import deepcopy

import numpy as np


def pseudo_label(dataset, event_classes, pseudo_tags, pseudo_boundaries,
                 pseudo_events, tags, boundaries, events):
    if not any([pseudo_tags, pseudo_boundaries, pseudo_events]):
        return dataset
    assert not (pseudo_events and pseudo_boundaries)
    dataset = deepcopy(dataset)
    for audio_id in sorted(dataset.keys()):
        example = dataset[audio_id]
        if pseudo_tags:
            example['events'] = sorted([
                event_class
                for value, event_class in zip(
                    tags[audio_id], event_classes)
                if value > 0.5
            ])
        example['label_types'] = len(example['events']) * ['weak']
        if pseudo_events:
            set_onset_offset_times(example, events[audio_id], 'strong')
        elif pseudo_boundaries:
            set_onset_offset_times(
                example, boundaries[audio_id], 'boundaries')
    print('\nlabel rate', np.mean([
        len(dataset[audio_id]['events']) > 0
        for audio_id in sorted(dataset.keys())
    ]))
    for label_type in ['weak', 'boundaries', 'strong']:
        print(f'pseudo {label_type} labels rate', np.mean([
            t == label_type
            for audio_id in sorted(dataset.keys())
            for t in dataset[audio_id]['label_types']
        ]))
    return dataset


def set_onset_offset_times(example, detections, label_type='strong'):
    """Attach onset/offset times from a detection event list.

    Detected events of tagged classes get ``label_type`` spans; tagged
    classes with no detection fall back to a full-clip span with a 'weak'
    label type."""
    detected_labels = sorted({label for *_, label in detections})
    assert 'events' in example, example.keys()
    tags = sorted(set(example['events']))
    events = sorted(
        [event for event in detections if event[2] in tags]
        + [(0., example['audio_length'], event_class)
           for event_class in tags if event_class not in detected_labels]
    )
    if events:
        onsets, offsets, labels = zip(*events)
    else:
        onsets, offsets, labels = (), (), ()
    example['events_start_times'] = list(onsets)
    example['events_stop_times'] = list(offsets)
    example['events'] = list(labels)
    example['label_types'] = [
        label_type if label in detected_labels else 'weak'
        for label in example['events']
    ]
