"""Collar-based (event onset/offset) evaluation.

Capability parity with ``sed_scores_eval.collar_based.{fscore,
best_fscore}`` as used by the reference (``models/base/tuning.py:668-698``):
a detected event is a true positive if an unmatched ground-truth event of
the same class has onset within ``onset_collar`` and offset within
``max(offset_collar, offset_collar_rate * gt_length)``; unique greedy
matching; per-class f/p/r + macro/micro averages; optional onset/offset
distance sums for the bias-correction statistics; per-class best-threshold
search — EXACT over ALL distinct score values by default (change-point
enumeration, see ``evaluation/changepoints.py``), with an optional
quantile-capped approximate grid via ``max_thresholds=``.

The port's own copy of ``pb_sed_tpu/evaluation/collar_based.py``: the port
imports nothing of the JAX package. Keep the two in step.
"""
import numpy as np

from pb_sed_tpu_torch.evaluation.scores import (
    scores_to_event_list, validate_score_dataframe)


def _match_events(detections, references, onset_collar, offset_collar,
                  offset_collar_rate):
    """Greedy unique matching; returns (n_tp, onset_dist_sum,
    offset_dist_sum, matched_ref_flags)."""
    matched = [False] * len(references)
    tps = 0
    onset_dist = 0.
    offset_dist = 0.
    for d_on, d_off in detections:
        best = None
        best_dist = None
        for j, (r_on, r_off) in enumerate(references):
            if matched[j]:
                continue
            collar_off = max(offset_collar,
                             offset_collar_rate * (r_off - r_on))
            if (abs(d_on - r_on) <= onset_collar
                    and abs(d_off - r_off) <= collar_off):
                dist = abs(d_on - r_on) + abs(d_off - r_off)
                if best is None or dist < best_dist:
                    best = j
                    best_dist = dist
        if best is not None:
            matched[best] = True
            tps += 1
            onset_dist += d_on - references[best][0]
            offset_dist += d_off - references[best][1]
    return tps, onset_dist, offset_dist, matched


def _resolve_ground_truth(ground_truth):
    from pathlib import Path
    if isinstance(ground_truth, (str, Path)):
        from pb_sed_tpu_torch.evaluation.scores import read_ground_truth_events
        return read_ground_truth_events(ground_truth)
    return ground_truth


def _counts_at_threshold(scores, ground_truth, threshold, classes,
                         onset_collar, offset_collar, offset_collar_rate):
    stats = {c: {'tps': 0, 'fps': 0, 'n_ref': 0,
                 'onset_dist_sum': 0., 'offset_dist_sum': 0.}
             for c in classes}
    event_lists = scores_to_event_list(scores, threshold, classes)
    for clip_id, detections in event_lists.items():
        gt = ground_truth.get(clip_id, [])
        for c in classes:
            dets = [(on, off) for on, off, lb in detections if lb == c]
            refs = [(on, off) for on, off, lb in gt if lb == c]
            tps, ond, offd, _ = _match_events(
                dets, refs, onset_collar, offset_collar,
                offset_collar_rate)
            s = stats[c]
            s['tps'] += tps
            s['fps'] += len(dets) - tps
            s['n_ref'] += len(refs)
            s['onset_dist_sum'] += ond
            s['offset_dist_sum'] += offd
    return stats


def _f_p_r(stats, beta=1.):
    f, p, r = {}, {}, {}
    tp_sum = fp_sum = ref_sum = 0
    for c, s in stats.items():
        prec = s['tps'] / max(s['tps'] + s['fps'], 1)
        rec = s['tps'] / max(s['n_ref'], 1)
        f[c] = ((1 + beta ** 2) * prec * rec
                / max(beta ** 2 * prec + rec, 1e-15))
        p[c] = prec
        r[c] = rec
        tp_sum += s['tps']
        fp_sum += s['fps']
        ref_sum += s['n_ref']
    f['macro_average'] = float(np.mean([f[c] for c in stats]))
    p['macro_average'] = float(np.mean([p[c] for c in stats]))
    r['macro_average'] = float(np.mean([r[c] for c in stats]))
    prec = tp_sum / max(tp_sum + fp_sum, 1)
    rec = tp_sum / max(ref_sum, 1)
    f['micro_average'] = ((1 + beta ** 2) * prec * rec
                          / max(beta ** 2 * prec + rec, 1e-15))
    p['micro_average'] = prec
    r['micro_average'] = rec
    return f, p, r


def fscore(scores, ground_truth, threshold, *, onset_collar=.2,
           offset_collar=.2, offset_collar_rate=.2, beta=1.,
           return_onset_offset_dist_sum=False, num_jobs=1):
    del num_jobs
    ground_truth = _resolve_ground_truth(ground_truth)
    classes = None
    for clip_id in scores:
        _, classes = validate_score_dataframe(scores[clip_id], classes)
        break
    stats = _counts_at_threshold(
        scores, ground_truth, threshold, classes,
        onset_collar, offset_collar, offset_collar_rate)
    f, p, r = _f_p_r(stats, beta)
    if not return_onset_offset_dist_sum:
        stats = {c: {k: v for k, v in s.items()
                     if not k.endswith('_dist_sum')}
                 for c, s in stats.items()}
    return f, p, r, stats


def candidate_thresholds(scores, classes, max_thresholds=50):
    """Per-class threshold grid: exact midpoints when few distinct score
    values, quantile grid otherwise."""
    values = {c: [] for c in classes}
    for clip_id in scores:
        arr = scores[clip_id][classes].to_numpy()
        for i, c in enumerate(classes):
            values[c].append(arr[:, i])
    out = {}
    for c in classes:
        v = np.unique(np.concatenate(values[c]))
        if len(v) <= max_thresholds:
            mids = (v[1:] + v[:-1]) / 2
            out[c] = np.concatenate(([v[0] - 1e-3], mids, [v[-1] + 1e-3]))
        else:
            qs = np.quantile(v, np.linspace(0, 1, max_thresholds))
            out[c] = np.unique(qs)
    return out


def _counts_job(threshold, scores, ground_truth, classes, onset_collar,
                offset_collar, offset_collar_rate):
    """parallel_map job: threshold first, shared data after."""
    return _counts_at_threshold(
        scores, ground_truth, threshold, classes,
        onset_collar, offset_collar, offset_collar_rate)


def _collar_clip_job(item, ground_truth, classes, onset_collar,
                     offset_collar, offset_collar_rate):
    """Per-clip exact job: statistic staircase at every change point.

    Returns per class: (levels, stats (U, 4), base (4,), n_ref) with the
    statistic (tps, n_detections, onset_dist_sum, offset_dist_sum).
    """
    from pb_sed_tpu_torch.evaluation.changepoints import level_detections
    clip_id, arr, timestamps = item
    gt = ground_truth.get(clip_id, [])
    out = []
    for ki, c in enumerate(classes):
        refs = [(on, off) for on, off, lb in gt if lb == c]
        levels, detections = level_detections(arr[:, ki], timestamps)
        rows = []
        for dets in detections:
            if not refs:  # no same-class truth: every detection is a FP
                rows.append((0, len(dets), 0., 0.))
                continue
            tps, ond, offd, _ = _match_events(
                dets.tolist(), refs, onset_collar, offset_collar,
                offset_collar_rate)
            rows.append((tps, len(dets), ond, offd))
        base, stats = rows[0], rows[1:]
        out.append((levels, np.asarray(stats, dtype=float).reshape(
            len(levels), 4), np.asarray(base, dtype=float), len(refs)))
    return out


def _best_fscore_exact(scores, ground_truth, classes, *, onset_collar,
                       offset_collar, offset_collar_rate, beta,
                       min_precision, min_recall, num_jobs):
    """Exact best-F: per-class optimum over ALL score change points
    (the reference's sed_scores_eval.collar_based.best_fscore
    semantics)."""
    from pb_sed_tpu_torch.evaluation.changepoints import (
        CurveAccumulator, representative_thresholds)
    from pb_sed_tpu_torch.evaluation.parallel import parallel_map
    items = []
    for clip_id in scores:
        timestamps, _ = validate_score_dataframe(scores[clip_id], classes)
        items.append(
            (clip_id, scores[clip_id][classes].to_numpy(), timestamps))
    contributions = parallel_map(
        _collar_clip_job, items,
        (ground_truth, classes, onset_collar, offset_collar,
         offset_collar_rate),
        num_jobs=num_jobs)
    best_f, best_p, best_r, thresholds = {}, {}, {}, {}
    for ki, c in enumerate(classes):
        acc = CurveAccumulator(4)
        n_ref = 0
        for contrib in contributions:
            levels, stats, base, clip_n_ref = contrib[ki]
            acc.add(levels, stats, base)
            n_ref += clip_n_ref
        bps, curve = acc.merged()
        reps = representative_thresholds(bps)
        tps = curve[:, 0]
        n_det = curve[:, 1]
        prec = tps / np.maximum(n_det, 1)
        rec = tps / max(n_ref, 1)
        f = ((1 + beta ** 2) * prec * rec
             / np.maximum(beta ** 2 * prec + rec, 1e-15))
        valid = (prec >= min_precision) & (rec >= min_recall)
        if valid.any():
            fv = np.where(valid, f, -1.)
            # ties resolved toward the larger threshold (grid-path
            # behavior: max(..., key=(f, threshold)))
            idx = np.flatnonzero(fv == fv.max())[-1]
            best_f[c] = float(f[idx])
            best_p[c] = float(prec[idx])
            best_r[c] = float(rec[idx])
            thresholds[c] = float(reps[idx])
        else:
            best_f[c] = best_p[c] = best_r[c] = 0.
            thresholds[c] = np.inf
    for d in (best_f, best_p, best_r):
        d['macro_average'] = float(np.mean([d[c] for c in classes]))
    stats = _counts_at_threshold(
        scores, ground_truth, thresholds, classes,
        onset_collar, offset_collar, offset_collar_rate)
    return best_f, best_p, best_r, thresholds, stats


def best_fscore(scores, ground_truth, *, onset_collar=.2, offset_collar=.2,
                offset_collar_rate=.2, beta=1., min_precision=0.,
                min_recall=0., max_thresholds=None, num_jobs=1):
    """Per-class best F over thresholds.

    Default (``max_thresholds=None``): EXACT enumeration over all
    distinct score values (change points), matching the reference's
    sed_scores_eval semantics. Pass ``max_thresholds=N`` for the
    quantile-capped approximate grid (cheaper on dense score sets).
    """
    ground_truth = _resolve_ground_truth(ground_truth)
    classes = None
    for clip_id in scores:
        _, classes = validate_score_dataframe(scores[clip_id], classes)
        break
    if max_thresholds is None:
        return _best_fscore_exact(
            scores, ground_truth, classes,
            onset_collar=onset_collar, offset_collar=offset_collar,
            offset_collar_rate=offset_collar_rate, beta=beta,
            min_precision=min_precision, min_recall=min_recall,
            num_jobs=num_jobs)
    grids = candidate_thresholds(scores, classes, max_thresholds)
    # evaluate the union grid once per threshold; each class picks its best
    union = np.unique(np.concatenate(list(grids.values())))
    from pb_sed_tpu_torch.evaluation.parallel import parallel_map
    all_stats = parallel_map(
        _counts_job, [float(t) for t in union],
        (scores, ground_truth, classes, onset_collar, offset_collar,
         offset_collar_rate),
        num_jobs=num_jobs)
    per_class_curves = {c: [] for c in classes}
    for thr, stats in zip(union, all_stats):
        f, p, r = _f_p_r(stats, beta)
        for c in classes:
            per_class_curves[c].append((float(thr), f[c], p[c], r[c]))
    best_f, best_p, best_r, thresholds = {}, {}, {}, {}
    for c in classes:
        curve = per_class_curves[c]
        valid = [
            (f_, p_, r_, thr) for thr, f_, p_, r_ in curve
            if p_ >= min_precision and r_ >= min_recall
        ]
        if valid:
            f_, p_, r_, thr = max(valid, key=lambda x: (x[0], x[3]))
        else:
            f_, p_, r_, thr = 0., 0., 0., np.inf
        best_f[c], best_p[c], best_r[c] = f_, p_, r_
        thresholds[c] = thr
    best_f['macro_average'] = float(np.mean(
        [best_f[c] for c in classes]))
    best_p['macro_average'] = float(np.mean(
        [best_p[c] for c in classes]))
    best_r['macro_average'] = float(np.mean(
        [best_r[c] for c in classes]))
    stats = _counts_at_threshold(
        scores, ground_truth, thresholds, classes,
        onset_collar, offset_collar, offset_collar_rate)
    return best_f, best_p, best_r, thresholds, stats
