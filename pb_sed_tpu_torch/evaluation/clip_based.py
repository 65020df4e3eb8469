"""Clip-based (tagging) evaluation.

Capability parity with ``sed_scores_eval.clip_based.{fscore, best_fscore}``
as used by the reference (``models/base/tuning.py:659-665``,
``experiments/weak_label_crnn/inference.py:66-135``): clip tag score = max
score over time per class; f-scores per class + macro/micro averages; best
threshold per class via the exact threshold sweep from
evaluation/instance_based.py.

The port's own copy of ``pb_sed_tpu/evaluation/clip_based.py``: the port
imports nothing of the JAX package. Keep the two in step.
"""
import numpy as np

from pb_sed_tpu_torch.evaluation import instance_based
from pb_sed_tpu_torch.evaluation.scores import validate_score_dataframe


def _clip_scores_and_targets(scores, ground_truth, event_classes=None):
    """Returns (clip_ids, (N, K) scores, (N, K) targets, classes)."""
    from pathlib import Path
    if isinstance(ground_truth, (str, Path)):
        from pb_sed_tpu_torch.evaluation.scores import read_ground_truth_tags
        ground_truth = read_ground_truth_tags(ground_truth)[0]
    clip_ids = sorted(scores.keys())
    classes = None
    score_rows = []
    for clip_id in clip_ids:
        _, classes = validate_score_dataframe(
            scores[clip_id], event_classes=classes)
        score_rows.append(scores[clip_id][classes].to_numpy().max(0))
    score_mat = np.stack(score_rows)
    target_mat = np.zeros_like(score_mat)
    for i, clip_id in enumerate(clip_ids):
        gt = ground_truth.get(clip_id, [])
        labels = {ev[2] for ev in gt} if gt and isinstance(
            gt[0], (tuple, list)) else set(gt)
        for label in labels:
            if label in classes:
                target_mat[i, classes.index(label)] = 1.
    return clip_ids, score_mat, target_mat, classes


def fscore(scores, ground_truth, threshold, beta=1., num_jobs=1):
    """F-score at given per-class (dict) or scalar threshold."""
    del num_jobs
    _, score_mat, target_mat, classes = _clip_scores_and_targets(
        scores, ground_truth)
    if isinstance(threshold, dict):
        thr = np.array([threshold[c] for c in classes])
    else:
        thr = np.broadcast_to(np.asarray(threshold, float), (len(classes),))
    decisions = score_mat > thr
    f, p, r = instance_based.fscore(target_mat, decisions, beta=beta,
                                    event_wise=True)
    f_micro, p_micro, r_micro = instance_based.fscore(
        target_mat, decisions, beta=beta, event_wise=False)
    fd = {c: float(f[i]) for i, c in enumerate(classes)}
    pd_ = {c: float(p[i]) for i, c in enumerate(classes)}
    rd = {c: float(r[i]) for i, c in enumerate(classes)}
    fd['macro_average'] = float(f.mean())
    pd_['macro_average'] = float(p.mean())
    rd['macro_average'] = float(r.mean())
    fd['micro_average'] = float(f_micro)
    pd_['micro_average'] = float(p_micro)
    rd['micro_average'] = float(r_micro)
    stats = {
        c: {'tps': float((target_mat[:, i] * decisions[:, i]).sum()),
            'fps': float(((1 - target_mat[:, i]) * decisions[:, i]).sum()),
            'n_ref': float(target_mat[:, i].sum())}
        for i, c in enumerate(classes)
    }
    return fd, pd_, rd, stats


def best_fscore(scores, ground_truth, beta=1., min_precision=0.,
                min_recall=0., num_jobs=1):
    """Exact per-class best threshold sweep (all distinct clip scores)."""
    del num_jobs
    _, score_mat, target_mat, classes = _clip_scores_and_targets(
        scores, ground_truth)
    thr, f, p, r = instance_based.get_best_fscore_thresholds(
        target_mat, score_mat, beta=beta,
        min_precision=min_precision, min_recall=min_recall)
    fd = {c: float(f[i]) for i, c in enumerate(classes)}
    pd_ = {c: float(p[i]) for i, c in enumerate(classes)}
    rd = {c: float(r[i]) for i, c in enumerate(classes)}
    thresholds = {c: float(thr[i]) for i, c in enumerate(classes)}
    fd['macro_average'] = float(f.mean())
    pd_['macro_average'] = float(p.mean())
    rd['macro_average'] = float(r.mean())
    decisions = score_mat > np.array([thresholds[c] for c in classes])
    f_micro, p_micro, r_micro = instance_based.fscore(
        target_mat, decisions, beta=beta)
    fd['micro_average'] = float(f_micro)
    pd_['micro_average'] = float(p_micro)
    rd['micro_average'] = float(r_micro)
    stats = {}
    return fd, pd_, rd, thresholds, stats
