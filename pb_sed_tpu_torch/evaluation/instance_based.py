"""Instance-based (clip/frame-level) metrics.

Capability parity with ``pb_sed/evaluation/instance_based.py:4-375``:
decision-based counts (tp/fp/tn/fn, f-score, error rate), threshold-sweep
curves (``fscore_curve`` / ``er_curve``) over all distinct score values,
best-threshold selection with ``min_precision`` / ``min_recall``
constraints, and label-weighted label-ranking average precision (lwlrap).

Fresh vectorized numpy implementation; the threshold sweep works on the
unique sorted score values with cumulative counts (no per-threshold loop).
"""
import numpy as np


def tp_fp_tn_fn(target_mat, decision_mat, reduce_axis=None):
    """Counts of true/false positives/negatives given binary decisions."""
    target_mat = np.asarray(target_mat, dtype=float)
    decision_mat = np.asarray(decision_mat, dtype=float)
    tp = target_mat * decision_mat
    fp = (1. - target_mat) * decision_mat
    tn = (1. - target_mat) * (1. - decision_mat)
    fn = target_mat * (1. - decision_mat)
    if reduce_axis is not None:
        tp, fp, tn, fn = (
            a.sum(axis=reduce_axis) for a in (tp, fp, tn, fn))
    return tp, fp, tn, fn


def fscore(target_mat, decision_mat, beta=1., event_wise=False):
    """Instance-based f-beta score from binary decisions.

    Returns (fscore, precision, recall); with ``event_wise`` per class.
    """
    reduce_axis = -2 if event_wise else (-2, -1)
    tp, fp, _, fn = tp_fp_tn_fn(target_mat, decision_mat, reduce_axis)
    p = tp / np.maximum(tp + fp, 1)
    r = tp / np.maximum(tp + fn, 1)
    f = (1 + beta ** 2) * p * r / np.maximum(beta ** 2 * p + r, 1e-15)
    return f, p, r


def substitutions_insertions_deletions(
        target_mat, decision_mat, reduce_axis=None):
    """S/I/D counts for the segment-based error rate.

    When the class axis is reduced, per-instance insertions/deletions are
    first paired into substitutions (min(i, d) per instance).
    """
    _, ins, _, dels = tp_fp_tn_fn(target_mat, decision_mat, None)
    ndim = np.asarray(decision_mat).ndim
    axes = reduce_axis if isinstance(reduce_axis, (tuple, list)) else (
        (reduce_axis,) if reduce_axis is not None else ())
    reduces_classes = any(a in (-1, ndim - 1) for a in axes)
    if reduces_classes:
        ins = ins.sum(axis=-1, keepdims=True)
        dels = dels.sum(axis=-1, keepdims=True)
        subs = np.minimum(ins, dels)
        ins = ins - subs
        dels = dels - subs
    else:
        subs = np.zeros_like(ins)
    if reduce_axis is not None:
        subs = subs.sum(axis=reduce_axis)
        ins = ins.sum(axis=reduce_axis)
        dels = dels.sum(axis=reduce_axis)
    return subs, ins, dels


def error_rate(target_mat, decision_mat, event_wise=False):
    """Instance-based error rate: (i + d + s) / n_ref."""
    reduce_axis = -2 if event_wise else (-2, -1)
    s, i, d = substitutions_insertions_deletions(
        target_mat, decision_mat, reduce_axis=reduce_axis)
    n_ref = np.maximum(np.asarray(target_mat).sum(axis=reduce_axis), 1)
    return (i + d + s) / n_ref, s / n_ref, i / n_ref, d / n_ref


def _threshold_sweep(targets, scores):
    """Cumulative counts for thresholds between adjacent score values.

    Returns (thresholds, n_detected, n_true_positive) where entry j holds
    the counts for decisions ``score > thresholds[j]``.
    ``thresholds`` = [-inf, midpoints of unique scores..., +inf].
    """
    targets = np.asarray(targets, dtype=float)
    scores = np.asarray(scores, dtype=float)
    order = np.argsort(scores, kind='mergesort')
    s_sorted = scores[order]
    t_sorted = targets[order]
    uniq, first_idx = np.unique(s_sorted, return_index=True)
    # decisions score > thr for thr just below uniq[j] keep items from
    # first_idx[j] onward
    tp_tail = np.concatenate((np.cumsum(t_sorted[::-1])[::-1], [0.]))
    n = len(scores)
    thresholds = np.concatenate((
        [-np.inf], (uniq[1:] + uniq[:-1]) / 2, [np.inf]))
    cut = np.concatenate((first_idx, [n]))
    n_detected = n - cut
    n_tp = tp_tail[cut]
    return thresholds, n_detected, n_tp


def fscore_curve(targets, scores, beta=1.,
                 tp_bias=0, n_ref_bias=0, n_pos_bias=0):
    """F-score for every threshold between adjacent score values.

    1-D input: arrays of shape (num_thresholds,); 2-D input (instances x
    classes): per-class curves padded to a common length with their edge
    values (each class keeps its own threshold grid).
    """
    targets = np.asarray(targets)
    scores = np.asarray(scores)
    assert targets.shape == scores.shape, (targets.shape, scores.shape)
    if scores.ndim == 2:
        curves = [
            fscore_curve(targets[:, k], scores[:, k], beta,
                         tp_bias, n_ref_bias, n_pos_bias)
            for k in range(scores.shape[1])
        ]
        return tuple(
            _pad_stack([c[i] for c in curves]) for i in range(4))
    thresholds, n_pos, tps = _threshold_sweep(targets, scores)
    n_ref = targets.sum()
    p = (tps + tp_bias) / np.maximum(n_pos + n_pos_bias, 1)
    r = (tps + tp_bias) / np.maximum(n_ref + n_ref_bias, 1)
    f = (1 + beta ** 2) * p * r / (beta ** 2 * p + r + 1e-18)
    return thresholds, f, p, r


def _pad_stack(arrays):
    """Stack 1-D arrays of different lengths, repeating the last value."""
    n = max(len(a) for a in arrays)
    out = np.stack([
        np.concatenate((a, np.full(n - len(a), a[-1]))) for a in arrays
    ])
    return out.T  # (num_thresholds, num_classes)


def get_best_fscore_thresholds(
        targets, scores, beta=1., min_precision=0., min_recall=0.,
        tp_bias=0, n_ref_bias=0, n_pos_bias=0):
    """Best threshold per class (ties resolved to the largest threshold)."""
    thresholds, f, p, r = fscore_curve(
        targets, scores, beta, tp_bias, n_ref_bias, n_pos_bias)
    assert min_precision == 0. or min_recall == 0.
    f = f.copy()
    f[p < min_precision] = 0.
    f[r < min_recall] = 0.
    best = len(f) - 1 - np.argmax(f[::-1], axis=0)
    if f.ndim == 1:
        return thresholds[best], f[best], p[best], r[best]
    k = np.arange(f.shape[1])
    return thresholds[best, k], f[best, k], p[best, k], r[best, k]


def er_curve(targets, scores):
    """Error rate for every threshold between adjacent score values."""
    targets = np.asarray(targets)
    scores = np.asarray(scores)
    assert targets.shape == scores.shape
    if scores.ndim == 2:
        curves = [er_curve(targets[:, k], scores[:, k])
                  for k in range(scores.shape[1])]
        return tuple(_pad_stack([c[i] for c in curves]) for i in range(4))
    thresholds, n_pos, tps = _threshold_sweep(targets, scores)
    n_ref = max(targets.sum(), 1)
    i = n_pos - tps
    d = targets.sum() - tps
    return thresholds, (i + d) / n_ref, i / n_ref, d / n_ref


def get_best_er_thresholds(
        targets, scores, max_insertion_rate=None, max_deletion_rate=None):
    thresholds, er, ir, dr = er_curve(targets, scores)
    er = er.copy()
    if max_insertion_rate is not None:
        er[ir > max_insertion_rate] = np.inf
    if max_deletion_rate is not None:
        er[dr > max_deletion_rate] = np.inf
    best = len(er) - 1 - np.argmin(er[::-1], axis=0)
    if er.ndim == 1:
        return thresholds[best], er[best], ir[best], dr[best]
    k = np.arange(er.shape[1])
    return thresholds[best, k], er[best, k], ir[best, k], dr[best, k]


def positive_class_precisions(target_mat, score_mat):
    """Precision-at-hit for every positive label (the lwlrap
    decomposition of the official reference implementation,
    ``pb_sed/evaluation/instance_based.py:190-229`` public surface).

    Returns (pos_class_indices, precision_at_hits): for each positive
    (sample, class) pair, the class index and the ranking precision at
    the rank where that class's score lands within its sample.
    """
    target_mat = np.asarray(target_mat) > 0
    score_mat = np.asarray(score_mat, dtype=float)
    assert score_mat.ndim == 2 and target_mat.shape == score_mat.shape
    num_classes = score_mat.shape[1]
    ranking = np.argsort(-score_mat, axis=-1)
    ranked_truth = np.take_along_axis(target_mat, ranking, axis=-1)
    hits = np.cumsum(ranked_truth, axis=-1)
    prec_at_rank = hits / np.arange(1, num_classes + 1)[None, :]
    rows, cols = np.nonzero(ranked_truth)
    return ranking[rows, cols], prec_at_rank[rows, cols]


def lwlrap_from_precisions(precision_at_hits, pos_class_indices,
                           num_classes):
    """Aggregate per-hit precisions into (lwlrap, per_class_lwlrap,
    weight_per_class)."""
    per_class_sum = np.zeros(num_classes)
    per_class_count = np.zeros(num_classes)
    np.add.at(per_class_sum, pos_class_indices, precision_at_hits)
    np.add.at(per_class_count, pos_class_indices, 1)
    per_class = per_class_sum / np.maximum(per_class_count, 1)
    total = per_class_count.sum()
    weight = per_class_count / max(total, 1)
    return float((per_class * weight).sum()), per_class, weight


def lwlrap(target_mat, score_mat):
    """Label-weighted label-ranking average precision.

    Returns (lwlrap, per_class_lwlrap, weight_per_class).
    """
    target_mat = np.asarray(target_mat) > 0
    score_mat = np.asarray(score_mat, dtype=float)
    if not target_mat.any():
        return 0.0, np.zeros(target_mat.shape[-1]), np.zeros(
            target_mat.shape[-1])
    assert score_mat.ndim == 2 and target_mat.shape == score_mat.shape
    num_samples, num_classes = score_mat.shape
    # rank classes per sample by descending score
    ranking = np.argsort(-score_mat, axis=-1)
    ranked_truth = np.take_along_axis(target_mat, ranking, axis=-1)
    hits = np.cumsum(ranked_truth, axis=-1)
    ranks = np.arange(1, num_classes + 1)[None, :]
    prec_at_rank = hits / ranks
    per_class_sum = np.zeros(num_classes)
    per_class_count = np.zeros(num_classes)
    rows, cols = np.nonzero(ranked_truth)
    true_classes = ranking[rows, cols]
    np.add.at(per_class_sum, true_classes, prec_at_rank[rows, cols])
    np.add.at(per_class_count, true_classes, 1)
    per_class = per_class_sum / np.maximum(per_class_count, 1)
    weight = per_class_count / per_class_count.sum()
    return float((per_class * weight).sum()), per_class, weight
