"""FBCRNN hyper-parameter tuning experiment.

Capability parity with ``pb_sed/experiments/weak_label_crnn/tuning.py``:
loads an ensemble group dir (glob ``202*``) with
``ckpt_best_macro_fscore_weak`` checkpoints; four stages:
(1) tagging thresholds vs clip-F1, (2) boundary detection (stepfilt grid,
collar .5/.5, min_precision .8, tag masking), (3) SED scenario 1 (window
grid, medfilt grid, collar-F1 + PSDS1-AUC), (4) SED scenario 2 (window
250/shift 250, PSDS2-AUC); derives per-class thresholds for the psds
paramsets via collar best-F1 on the tuned scores; writes
``{tagging,boundaries_detection,sed}_hyper_params_*.json``; symlinks the
hyper-params dir into the model dirs; auto-chains evaluation.

Ground truth: an explicit TSV path, or (new) derived directly from the
database json when the corpus metadata TSVs are not available.

The port's counterpart of ``pb_sed_tpu/experiments/weak_label_crnn/
tuning.py``, with the same config, grids and files. One difference: the
``device`` config (``None``: the card, ``'cpu'`` for a CPU run) is the
device the models are restored on, and the chained inference runs get
it too (the JAX experiment accepts ``device`` and reads it nowhere).

Run: ``python -m pb_sed_tpu_torch.experiments.weak_label_crnn.tuning with
group_dir=<training group dir> ...``
"""
import os
from functools import partial
from pathlib import Path

import numpy as np

from pb_sed_tpu_torch.data.provider import DataProvider
from pb_sed_tpu_torch.evaluation import collar_based
from pb_sed_tpu_torch.experiments.core import (
    Experiment, FileStorageObserver, print_config)
from pb_sed_tpu_torch.models import base, weak_label
from pb_sed_tpu_torch.models.weak_label import crnn as weak_label_crnn
from pb_sed_tpu_torch.parallel.mesh import barrier, is_main_process
from pb_sed_tpu_torch.paths import storage_root
from pb_sed_tpu_torch.train.emissions import EmissionsTracker
from pb_sed_tpu_torch.utils.misc import dump_json, load_json, timestamp

ex_name = 'weak_label_crnn_hyper_params'
ex = Experiment(ex_name)


@ex.config
def config(cfg):
    cfg['debug'] = False
    debug = cfg['debug']
    cfg['timestamp'] = timestamp() + ('_debug' if debug else '')

    cfg['group_dir'] = ''
    group_dir = cfg['group_dir']
    if 'crnn_dirs' not in cfg:
        if isinstance(group_dir, list):
            dirs = [d for g in group_dir for d in Path(g).glob('202*')
                    if d.is_dir()]
        else:
            dirs = [d for d in Path(group_dir).glob('202*') if d.is_dir()]
        cfg.force('crnn_dirs', sorted(str(d) for d in dirs))
    assert len(cfg['crnn_dirs']) > 0, 'crnn_dirs must not be empty.'
    cfg['crnn_checkpoints'] = 'ckpt_best_macro_fscore_weak.pkl'
    crnn_config = load_json(Path(cfg['crnn_dirs'][0]) / '1' / 'config.json')
    cfg['data_provider'] = crnn_config['data_provider']
    cfg['database_name'] = crnn_config.get('database_name', 'desed')
    cfg['storage_dir'] = str(
        storage_root / 'weak_label_crnn' / cfg['database_name']
        / 'hyper_params' / cfg['timestamp'])
    cfg['data_provider']['min_audio_length'] = .01
    cfg['data_provider']['cached_datasets'] = None

    cfg['device'] = None
    cfg['validation_set_name'] = 'validation'
    cfg['validation_ground_truth_filepath'] = None
    cfg['eval_set_name'] = 'eval_public'
    cfg['eval_ground_truth_filepath'] = None

    cfg['boundaries_filter_lengths'] = \
        [20] if debug else [100, 80, 60, 50, 40, 30, 20, 10, 0]

    cfg['tune_detection_scenario_1'] = True
    cfg['detection_window_lengths_scenario_1'] = \
        [11] if debug else [51, 41, 31, 21, 11]
    cfg['detection_window_shift_scenario_1'] = 1
    cfg['detection_medfilt_lengths_scenario_1'] = \
        [11] if debug else [101, 81, 61, 51, 41, 31, 21, 11]

    cfg['tune_detection_scenario_2'] = True
    cfg['detection_window_lengths_scenario_2'] = [250]
    cfg['detection_window_shift_scenario_2'] = 250
    cfg['detection_medfilt_lengths_scenario_2'] = [1]

    ex.observers.append(FileStorageObserver.create(cfg['storage_dir']))


def ground_truth_from_json(data_provider, dataset_name):
    """{clip_id: [(onset, offset, label)]} + tags + durations from the
    database json (replaces the reference's corpus-tree tsv lookup)."""
    events, tags, durations = {}, {}, {}
    for example in data_provider.db.get_dataset(dataset_name):
        clip_id = example['example_id']
        durations[clip_id] = example.get('audio_length', 0.)
        labels = example.get('events', [])
        if 'events_start_times' in example:
            events[clip_id] = list(zip(
                example['events_start_times'],
                example['events_stop_times'], labels))
        else:
            events[clip_id] = []
        tags[clip_id] = sorted(set(labels))
    return events, tags, durations


@ex.automain
def main(_config, storage_dir, debug, crnn_dirs, crnn_checkpoints,
         data_provider, validation_set_name,
         validation_ground_truth_filepath, eval_set_name,
         eval_ground_truth_filepath, boundaries_filter_lengths,
         tune_detection_scenario_1, detection_window_lengths_scenario_1,
         detection_window_shift_scenario_1,
         detection_medfilt_lengths_scenario_1, tune_detection_scenario_2,
         detection_window_lengths_scenario_2,
         detection_window_shift_scenario_2,
         detection_medfilt_lengths_scenario_2, device):
    print('\n##### Tuning #####\n')
    print_config(_config)
    print(storage_dir)
    storage_dir = Path(storage_dir)
    writes = is_main_process()   # every rank computes, rank 0 writes
    if writes:
        storage_dir.mkdir(parents=True, exist_ok=True)
        emissions_tracker = EmissionsTracker(output_dir=storage_dir)
        emissions_tracker.start()

    boundaries_collar_based_params = {
        'onset_collar': .5, 'offset_collar': .5,
        'offset_collar_rate': .0, 'min_precision': .8,
    }
    collar_based_params = {
        'onset_collar': .2, 'offset_collar': .2,
        'offset_collar_rate': .2,
    }
    psds_scenario_1 = {
        'dtc_threshold': 0.7, 'gtc_threshold': 0.7,
        'cttc_threshold': None, 'alpha_ct': .0, 'alpha_st': 1.,
    }
    psds_scenario_2 = {
        'dtc_threshold': 0.1, 'gtc_threshold': 0.1,
        'cttc_threshold': 0.3, 'alpha_ct': .5, 'alpha_st': 1.,
    }

    if not isinstance(crnn_checkpoints, list):
        crnn_checkpoints = len(crnn_dirs) * [crnn_checkpoints]
    crnns = [
        weak_label.CRNN.from_storage_dir(
            storage_dir=crnn_dir, config_name='1/config.json',
            checkpoint_name=ckpt, device=device)
        for crnn_dir, ckpt in zip(crnn_dirs, crnn_checkpoints)
    ]
    data_provider = DataProvider.from_config(data_provider)
    # every rank reads the whole sets: the engine splits each batch over
    # the ranks itself (``mesh='auto'``) and gives every rank all scores
    data_provider.test_fetcher.num_shards = 1
    data_provider.test_transform.label_encoder.initialize_labels()
    inverse = data_provider.test_transform.label_encoder.\
        inverse_label_mapping
    event_classes = [inverse[i] for i in range(len(inverse))]
    frame_shift = (data_provider.test_transform.stft.shift
                   / data_provider.audio_reader.target_sample_rate)

    dataset = data_provider.get_dataset(validation_set_name)
    gt_events, gt_tags, audio_durations = ground_truth_from_json(
        data_provider, validation_set_name)
    if validation_ground_truth_filepath is not None:
        tagging_ground_truth = validation_ground_truth_filepath
        events_ground_truth = validation_ground_truth_filepath
    else:
        tagging_ground_truth = gt_tags
        events_ground_truth = gt_events

    # stage 1: tagging thresholds
    timestamps = {
        audio_id: np.array([0., audio_durations[audio_id]])
        for audio_id in audio_durations
    }
    metrics = {'f': partial(base.f_tag, ground_truth=tagging_ground_truth,
                            num_jobs=8)}
    leaderboard = weak_label_crnn.tune_tagging(
        crnns, dataset, timestamps, event_classes, metrics,
        storage_dir=storage_dir if writes else None)
    _, hyper_params, tagging_scores = leaderboard['f']
    tagging_thresholds = np.array([
        hyper_params[event_class]['threshold']
        for event_class in event_classes
    ])
    tags = {
        audio_id:
            tagging_scores[audio_id][event_classes].to_numpy()
            > tagging_thresholds
        for audio_id in tagging_scores
    }

    # stage 2: boundary detection
    boundaries_ground_truth = base.boundaries_from_events(
        events_ground_truth)
    timestamps = np.arange(0, 10000) * frame_shift
    metrics = {
        'f': partial(
            base.f_collar, ground_truth=boundaries_ground_truth,
            return_onset_offset_bias=True, num_jobs=8,
            **boundaries_collar_based_params),
    }
    weak_label_crnn.tune_boundary_detection(
        crnns, dataset, timestamps, event_classes, tags, metrics,
        tag_masking=True, stepfilt_lengths=boundaries_filter_lengths,
        storage_dir=storage_dir if writes else None)

    # stage 3: SED scenario 1
    if tune_detection_scenario_1:
        metrics = {
            'f': partial(
                base.f_collar, ground_truth=events_ground_truth,
                return_onset_offset_bias=True, num_jobs=8,
                **collar_based_params),
            'auc': partial(
                base.psd_auc, ground_truth=events_ground_truth,
                audio_durations=audio_durations, num_jobs=8,
                **psds_scenario_1),
        }
        leaderboard = weak_label_crnn.tune_sound_event_detection(
            crnns, dataset, timestamps, event_classes, tags, metrics,
            tag_masking={'f': True, 'auc': '?'},
            window_lengths=detection_window_lengths_scenario_1,
            window_shift=detection_window_shift_scenario_1,
            medfilt_lengths=detection_medfilt_lengths_scenario_1)
        if writes:
            dump_json(leaderboard['f'][1],
                      storage_dir / 'sed_hyper_params_f.json')
        f, p, r, thresholds, _ = collar_based.best_fscore(
            leaderboard['auc'][2], events_ground_truth,
            **collar_based_params, num_jobs=8)
        for event_class in thresholds:
            leaderboard['auc'][1][event_class]['threshold'] = \
                thresholds[event_class]
        if writes:
            dump_json(leaderboard['auc'][1],
                      storage_dir / 'sed_hyper_params_psds1.json')
    # stage 4: SED scenario 2
    if tune_detection_scenario_2:
        metrics = {
            'auc': partial(
                base.psd_auc, ground_truth=events_ground_truth,
                audio_durations=audio_durations, num_jobs=8,
                **psds_scenario_2),
        }
        leaderboard = weak_label_crnn.tune_sound_event_detection(
            crnns, dataset, timestamps, event_classes, tags, metrics,
            tag_masking=False,
            window_lengths=detection_window_lengths_scenario_2,
            window_shift=detection_window_shift_scenario_2,
            medfilt_lengths=detection_medfilt_lengths_scenario_2)
        f, p, r, thresholds, _ = collar_based.best_fscore(
            leaderboard['auc'][2], events_ground_truth,
            **collar_based_params, num_jobs=8)
        for event_class in thresholds:
            leaderboard['auc'][1][event_class]['threshold'] = \
                thresholds[event_class]
        if writes:
            dump_json(leaderboard['auc'][1],
                      storage_dir / 'sed_hyper_params_psds2.json')

    if writes:
        for crnn_dir in crnn_dirs:
            tuning_dir = Path(crnn_dir) / 'hyper_params'
            os.makedirs(str(tuning_dir), exist_ok=True)
            link = tuning_dir / storage_dir.name
            if not link.exists():
                link.symlink_to(storage_dir)
        emissions_tracker.stop()
    barrier()   # the inference below reads rank 0's files
    print(storage_dir)

    if eval_set_name:
        from pb_sed_tpu_torch.experiments.weak_label_crnn.inference import (
            ex as evaluation)
        if tune_detection_scenario_1:
            evaluation.run(config_updates={
                'debug': debug,
                'hyper_params_dir': str(storage_dir),
                'dataset_name': eval_set_name,
                'ground_truth_filepath': eval_ground_truth_filepath,
                'device': device,
            })
        if tune_detection_scenario_2:
            evaluation.run(config_updates={
                'debug': debug,
                'hyper_params_dir': str(storage_dir),
                'dataset_name': eval_set_name,
                'ground_truth_filepath': eval_ground_truth_filepath,
                'sed_hyper_params_name': 'psds2',
                'device': device,
            })
    return str(storage_dir)
