"""Per-class greedy hyper-parameter tuning with leaderboards.

Capability parity with ``pb_sed/models/base/tuning.py:13-343``:
``update_leaderboard`` keeps, per metric and per event class, the best
(metric value, hyper-params, scores) seen so far and maintains the
``macro_average``; ``tune_tagging`` (median-filter grid),
``tune_boundaries_detection`` (medfilt x stepfilt x tag-masking grid) and
``tune_sound_event_detection`` (medfilt x tag-masking grid) dump
``*_hyper_params_<metric>.json``; metric adapters ``f_tag`` (clip best-F1 +
thresholds), ``f_collar`` (collar best-F1 + onset/offset bias) and
``psd_auc`` (per-class staircase AUC of the PSDS ROC);
``boundaries_from_events`` folds event lists to one span per class.

The port's own copy of ``pb_sed_tpu/models/base/tuning.py`` on the port's
score frames (``evaluation.scores.ScoreFrame``): the port imports nothing
of the JAX package. Keep the two in step.
"""
from copy import deepcopy
from pathlib import Path

import numpy as np

from pb_sed_tpu_torch.evaluation import clip_based, collar_based, \
    intersection_based
from pb_sed_tpu_torch.evaluation.intersection_based import staircase_auc
from pb_sed_tpu_torch.evaluation.scores import validate_score_dataframe
from pb_sed_tpu_torch.ops.filters import boundariesfilt, medfilt
from pb_sed_tpu_torch.utils.misc import dump_json


def _lower_is_better(minimize, metric_name):
    """Resolve the per-metric optimization direction: ``minimize`` may
    be a bool (all metrics), a collection of minimized metric names, or
    a per-metric dict."""
    if isinstance(minimize, dict):
        return bool(minimize[metric_name])
    if isinstance(minimize, (list, tuple, set, frozenset)):
        return metric_name in minimize
    return bool(minimize)


def update_leaderboard(leaderboard, metric_name, metric_values,
                       hyper_params_and_other_values, scores,
                       minimize=False):
    """Fold one tuning-grid point into ``leaderboard[metric_name]``.

    Entry layout — a cross-module contract shared with the reference's
    tuning surface (``pb_sed/models/base/tuning.py:13-47``) and consumed
    by ``_dump_leaderboard`` and the ``tune_*`` drivers:
    ``(best_value_per_class, best_hyper_params_per_class,
    best_scores_per_clip)``, with a ``'macro_average'`` entry maintained
    inside the value dict.

    Per event class independently: the candidate grid point wins on a
    tie-or-better metric value, in which case the class's hyper-params
    absorb the candidate's dict and every clip's score column for that
    class is overwritten with the candidate's scores (so the stored
    score dataframes are per-class mosaics of the winning settings).
    """
    classes = list(hyper_params_and_other_values)
    if metric_name not in leaderboard:
        leaderboard[metric_name] = (
            {c: metric_values[c] for c in classes},
            deepcopy(hyper_params_and_other_values),
            deepcopy(scores),
        )
    else:
        descending = _lower_is_better(minimize, metric_name)
        best_values, best_params, best_scores = leaderboard[metric_name]
        for c in classes:
            incumbent, candidate = best_values[c], metric_values[c]
            wins = (candidate <= incumbent if descending
                    else candidate >= incumbent)
            if not wins:
                continue
            best_values[c] = candidate
            best_params[c].update(hyper_params_and_other_values[c])
            for clip_id in best_scores:
                best_scores[clip_id][c] = scores[clip_id][c]
    best_values = leaderboard[metric_name][0]
    best_values['macro_average'] = float(
        np.mean([best_values[c] for c in classes]))
    return leaderboard


def _medfiltered(detection_scores, medfilt_len, event_classes=None):
    if medfilt_len <= 1:
        return detection_scores, event_classes
    out = deepcopy(detection_scores)
    for audio_id in sorted(detection_scores.keys()):
        _, event_classes = validate_score_dataframe(
            detection_scores[audio_id], event_classes=event_classes)
        arr = detection_scores[audio_id][event_classes].to_numpy()
        out[audio_id][event_classes] = medfilt(arr, medfilt_len, axis=0)
    return out, event_classes


def _tag_masked(scores, tags, event_classes=None):
    out = deepcopy(scores)
    for audio_id in sorted(scores.keys()):
        _, event_classes = validate_score_dataframe(
            scores[audio_id], event_classes=event_classes)
        out[audio_id][event_classes] *= tags[audio_id]
    return out, event_classes


def _dump_leaderboard(leaderboard, storage_dir, prefix):
    for metric_name in leaderboard:
        metric_values, hyper_params, _ = leaderboard[metric_name]
        for event_class in hyper_params:
            hyper_params[event_class][metric_name] = metric_values[
                event_class]
        if storage_dir is not None:
            dump_json(
                hyper_params,
                Path(storage_dir)
                / f'{prefix}_hyper_params_{metric_name}.json')


def _print_best(leaderboard, metrics):
    print('\nbest:')
    for metric_name in metrics:
        print(f'\n{metric_name}:')
        print(leaderboard[metric_name][0])


def tune_tagging(tagging_scores, medfilt_length_candidates, metrics,
                 minimize=False, storage_dir=None):
    leaderboard = {}
    event_classes = None
    for medfilt_len in medfilt_length_candidates:
        filtered, event_classes = _medfiltered(
            tagging_scores, medfilt_len, event_classes)
        for metric_name, metric_fn in metrics.items():
            values, others = metric_fn(filtered)
            print(f'\n{metric_name}(medfilt_length={medfilt_len})')
            print(values)
            hyper_params = {
                event_class: {'medfilt_length': medfilt_len,
                              **others.get(event_class, {})}
                for event_class in values
                if not event_class.endswith('_average')
            }
            leaderboard = update_leaderboard(
                leaderboard, metric_name, values, hyper_params, filtered,
                minimize=minimize)
    _dump_leaderboard(leaderboard, storage_dir, 'tagging')
    _print_best(leaderboard, metrics)
    return leaderboard


def boundaries_from_events(ground_truth):
    """Fold an event list to one (first onset, last offset) span per class
    per clip (reference ``tuning.py:478-497``)."""
    from pb_sed_tpu_torch.evaluation.scores import read_ground_truth_events
    if isinstance(ground_truth, (str, Path)):
        ground_truth = read_ground_truth_events(ground_truth)
    out = {}
    for audio_id, event_list in ground_truth.items():
        spans = {}
        for onset, offset, label in event_list:
            if label in spans:
                # span = (min onset, MAX offset): nested/unsorted events
                # must not shrink the fold
                spans[label] = (min(spans[label][0], onset),
                                max(spans[label][1], offset))
            else:
                spans[label] = (onset, offset)
        out[audio_id] = [
            (onset, offset, label)
            for label, (onset, offset) in spans.items()
        ]
    return out


def _normalize_tag_masking(tag_masking, metrics):
    if tag_masking in (True, False, '?'):
        tag_masking = {key: tag_masking for key in metrics}
    assert isinstance(tag_masking, dict), tag_masking
    assert tag_masking.keys() == metrics.keys(), (
        tag_masking.keys(), metrics.keys())
    assert all(v in (True, False, '?') for v in tag_masking.values())
    return tag_masking


def tune_boundaries_detection(
        detection_scores, medfilt_length_candidates,
        stepfilt_length_candidates, tags, metrics, minimize=False,
        tag_masking='?', storage_dir=None):
    tag_masking = _normalize_tag_masking(tag_masking, metrics)
    leaderboard = {}
    event_classes = None
    for medfilt_len in medfilt_length_candidates:
        medfiltered, event_classes = _medfiltered(
            detection_scores, medfilt_len, event_classes)
        for stepfilt_len in stepfilt_length_candidates:
            boundfiltered = deepcopy(medfiltered)
            for audio_id in sorted(medfiltered.keys()):
                _, event_classes = validate_score_dataframe(
                    medfiltered[audio_id], event_classes=event_classes)
                arr = medfiltered[audio_id][event_classes].to_numpy()
                boundfiltered[audio_id][event_classes] = boundariesfilt(
                    arr, stepfilt_len, axis=0)
            masked, event_classes = _tag_masked(
                boundfiltered, tags, event_classes)
            for metric_name, metric_fn in metrics.items():
                candidates = ([False, True]
                              if tag_masking[metric_name] == '?'
                              else [tag_masking[metric_name]])
                for tag_masked in candidates:
                    scores = masked if tag_masked else boundfiltered
                    values, others = metric_fn(scores)
                    print(f'\n{metric_name}(medfilt_length={medfilt_len},'
                          f'stepfilt_length={stepfilt_len},'
                          f'tag_masked={tag_masked}):')
                    print(values)
                    hyper_params = {
                        event_class: {
                            'medfilt_length': medfilt_len,
                            'stepfilt_length': stepfilt_len,
                            'tag_masked': tag_masked,
                            **others.get(event_class, {}),
                        }
                        for event_class in values
                        if not event_class.endswith('_average')
                    }
                    leaderboard = update_leaderboard(
                        leaderboard, metric_name, values, hyper_params,
                        scores, minimize=minimize)
    _dump_leaderboard(leaderboard, storage_dir, 'boundaries_detection')
    _print_best(leaderboard, metrics)
    return leaderboard


def tune_sound_event_detection(
        detection_scores, medfilt_length_candidates, tags, metrics,
        minimize=False, tag_masking='?', storage_dir=None):
    tag_masking = _normalize_tag_masking(tag_masking, metrics)
    leaderboard = {}
    event_classes = None
    for medfilt_len in medfilt_length_candidates:
        filtered, event_classes = _medfiltered(
            detection_scores, medfilt_len, event_classes)
        masked, event_classes = _tag_masked(filtered, tags, event_classes)
        for metric_name, metric_fn in metrics.items():
            candidates = ([False, True]
                          if tag_masking[metric_name] == '?'
                          else [tag_masking[metric_name]])
            for tag_masked in candidates:
                scores = masked if tag_masked else filtered
                values, others = metric_fn(scores)
                print(f'\n{metric_name}(medfilt_length={medfilt_len},'
                      f'tag_masked={tag_masked}):')
                print(values)
                hyper_params = {
                    event_class: {
                        'medfilt_length': medfilt_len,
                        'tag_masked': tag_masked,
                        **others.get(event_class, {}),
                    }
                    for event_class in values
                    if not event_class.endswith('_average')
                }
                leaderboard = update_leaderboard(
                    leaderboard, metric_name, values, hyper_params,
                    scores, minimize=minimize)
    _dump_leaderboard(leaderboard, storage_dir, 'sed')
    _print_best(leaderboard, metrics)
    return leaderboard


# ----------------------------------------------------------------------
# metric adapters (reference tuning.py:659-718)
# ----------------------------------------------------------------------
def f_tag(tagging_scores, *, ground_truth, num_jobs=1):
    best_f, best_p, best_r, thresholds, stats = clip_based.best_fscore(
        tagging_scores, ground_truth, num_jobs=num_jobs)
    return best_f, {
        key: {'threshold': thresholds[key]} for key in thresholds}


def f_collar(detection_scores, *, ground_truth, onset_collar,
             offset_collar, offset_collar_rate, min_precision=0.,
             min_recall=0., return_onset_offset_bias=False, num_jobs=1):
    best_f, best_p, best_r, thresholds, stats = collar_based.best_fscore(
        detection_scores, ground_truth, onset_collar=onset_collar,
        offset_collar=offset_collar,
        offset_collar_rate=offset_collar_rate,
        min_precision=min_precision, min_recall=min_recall,
        num_jobs=num_jobs)
    if return_onset_offset_bias:
        f, p, r, stats = collar_based.fscore(
            detection_scores, ground_truth, thresholds,
            onset_collar=onset_collar, offset_collar=offset_collar,
            offset_collar_rate=offset_collar_rate,
            return_onset_offset_dist_sum=True, num_jobs=num_jobs)
        return best_f, {
            key: {
                'threshold': thresholds[key],
                'onset_bias': stats[key]['onset_dist_sum']
                / max(stats[key]['tps'], 1),
                'offset_bias': stats[key]['offset_dist_sum']
                / max(stats[key]['tps'], 1),
            }
            for key in thresholds
        }
    return best_f, {
        key: {'threshold': thresholds[key]} for key in thresholds}


def psd_auc(detection_scores, *, ground_truth, audio_durations,
            dtc_threshold, gtc_threshold, cttc_threshold=None,
            alpha_ct=0., alpha_st=0., unit_of_time='hour', max_efpr=100.,
            time_decimals=6, num_jobs=1):
    _, _, classwise_rocs = intersection_based.psds(
        detection_scores, ground_truth, audio_durations,
        dtc_threshold=dtc_threshold, gtc_threshold=gtc_threshold,
        cttc_threshold=cttc_threshold, alpha_ct=alpha_ct,
        alpha_st=alpha_st, unit_of_time=unit_of_time, max_efpr=max_efpr,
        time_decimals=time_decimals, num_jobs=num_jobs)
    aucs = {
        event_class: staircase_auc(tpr, efpr, max_efpr)
        for event_class, (tpr, efpr, *_) in classwise_rocs.items()
    }
    return aucs, {}
