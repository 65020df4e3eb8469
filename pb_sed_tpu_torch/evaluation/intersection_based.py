"""Intersection-based evaluation: PSDS (polyphonic sound detection score).

Capability parity with ``sed_scores_eval.intersection_based.psds`` and
``intersection_based.reference.approximate_psds`` as used by the reference
(``models/base/tuning.py:701-718``,
``experiments/weak_label_crnn/inference.py:200-356``), plus
``utils.auc.staircase_auc``.

Semantics (PSDS, Bilen et al. 2020):
- DTC: a detection is valid if >= ``dtc_threshold`` of its duration
  intersects same-class ground truth; invalid detections are false
  positives.
- GTC: a ground-truth event is a true positive if >= ``gtc_threshold`` of
  its duration is covered by DTC-valid detections.
- CTTC: an invalid detection cross-triggers class c' if >=
  ``cttc_threshold`` of its duration intersects class-c' ground truth;
  cross-trigger rates are normalized by the total ground-truth duration of
  the triggered class and folded into the effective FPR with weight
  ``alpha_ct``.
- Per class: ROC of TPR vs effective FPR (per ``unit_of_time``) over the
  operating points; PSDS = area under the across-class mean TPR minus
  ``alpha_st`` times the across-class std, up to ``max_efpr``, normalized
  by ``max_efpr``.

Operating points: by default the EXACT set of all distinct score values
(change-point enumeration per class, matching sed_scores_eval); an
explicit grid can be passed via ``thresholds=`` —
:func:`approximate_psds` uses the official 50-threshold psds_eval-
compatible approximation.

The port's own copy of ``pb_sed_tpu/evaluation/intersection_based.py``:
the port imports nothing of the JAX package. Keep the two in step.
"""
import numpy as np

from pb_sed_tpu_torch.evaluation.scores import (
    event_list_from_score_array, validate_score_dataframe)

SECONDS_PER_UNIT = {'second': 1., 'minute': 60., 'hour': 3600.}

DEFAULT_THRESHOLDS = (np.arange(50) + .5) / 50


def staircase_auc(y, x, max_x=None):
    """Area under a right-continuous staircase y(x)."""
    y = np.asarray(y, dtype=float)
    x = np.asarray(x, dtype=float)
    order = np.argsort(x, kind='mergesort')
    x = x[order]
    y = y[order]
    if max_x is not None:
        keep = x <= max_x
        x = np.concatenate((x[keep], [max_x]))
        y = np.concatenate((y[keep], y[keep][-1:] if keep.any() else [0.]))
    widths = np.diff(x)
    return float(np.sum(widths * y[:-1]))


def _counts_job(threshold, scores_arrays, ground_truth, classes,
                dtc_threshold, gtc_threshold, cttc_threshold,
                time_decimals):
    """parallel_map job: threshold first, shared data after."""
    return _counts_at_threshold(
        scores_arrays, ground_truth, classes, threshold,
        dtc_threshold, gtc_threshold, cttc_threshold, time_decimals)


def _class_counts(dets, gt_by_class, classes, ki, dtc_threshold,
                  gtc_threshold, cttc_threshold, time_decimals=None):
    """DTC/GTC/CTTC counting for one clip/class detection list,
    vectorized over intervals (the exact path evaluates this at EVERY
    score change point, SURVEY §3.2's dominant tuning cost).

    Returns (tp, fp, cts_row (k,)).
    """
    k = len(classes)
    cts_row = np.zeros(k)
    n = len(dets)
    if n == 0:
        return 0, 0, cts_row
    det = np.asarray(dets, dtype=float).reshape(n, 2)
    if time_decimals is not None:
        det = np.round(det, time_decimals)
    d_on, d_off = det[:, 0], det[:, 1]
    dur = np.maximum(d_off - d_on, 1e-12)
    refs = gt_by_class.get(classes[ki], [])
    if refs:
        ref = np.asarray(refs, dtype=float).reshape(-1, 2)
        inter = np.clip(
            np.minimum(d_off[:, None], ref[None, :, 1])
            - np.maximum(d_on[:, None], ref[None, :, 0]), 0., None)
        valid = inter.sum(1) / dur >= dtc_threshold
    else:
        valid = np.zeros(n, dtype=bool)
    fp = int(n - valid.sum())
    if cttc_threshold is not None and fp:
        inv = ~valid
        for kj, c2 in enumerate(classes):
            if kj == ki:
                continue
            refs2 = gt_by_class.get(c2)
            if not refs2:
                continue
            ref2 = np.asarray(refs2, dtype=float).reshape(-1, 2)
            inter2 = np.clip(
                np.minimum(d_off[inv, None], ref2[None, :, 1])
                - np.maximum(d_on[inv, None], ref2[None, :, 0]),
                0., None)
            cts_row[kj] = float(
                (inter2.sum(1) / dur[inv] >= cttc_threshold).sum())
    tp = 0
    if refs and valid.any():
        covered = _merged_coverage(det[valid], ref)
        ref_dur = np.maximum(ref[:, 1] - ref[:, 0], 1e-12)
        tp = int((covered / ref_dur >= gtc_threshold).sum())
    return tp, fp, cts_row


def _merged_coverage(intervals, ref):
    """Per-ref length covered by the UNION of ``intervals`` ((n, 2)):
    merge-sweep (score runs are already disjoint; file-based detections
    might not be), then summed pairwise intersections."""
    order = np.argsort(intervals[:, 0], kind='mergesort')
    iv = intervals[order]
    merged = []
    cur_on, cur_off = iv[0]
    for on, off in iv[1:]:
        if on > cur_off:
            merged.append((cur_on, cur_off))
            cur_on, cur_off = on, off
        else:
            cur_off = max(cur_off, off)
    merged.append((cur_on, cur_off))
    mg = np.asarray(merged)
    inter = np.clip(
        np.minimum(mg[:, None, 1], ref[None, :, 1])
        - np.maximum(mg[:, None, 0], ref[None, :, 0]), 0., None)
    return inter.sum(0)


def _psds_clip_job(item, ground_truth, classes, dtc_threshold,
                   gtc_threshold, cttc_threshold, time_decimals):
    """Per-clip exact job: (tps, fps, cts...) staircase at every change
    point, per class. Returns per class: (levels, stats (U, 2+k),
    base (2+k,))."""
    from pb_sed_tpu_torch.evaluation.changepoints import level_detections
    clip_id, arr, timestamps = item
    gt = ground_truth.get(clip_id, [])
    gt_by_class = {}
    for on, off, lb in gt:
        gt_by_class.setdefault(lb, []).append((on, off))
    k = len(classes)
    out = []
    for ki in range(k):
        levels, detections = level_detections(arr[:, ki], timestamps)
        rows = []
        for dets in detections:
            tp, fp, cts_row = _class_counts(
                dets, gt_by_class, classes, ki, dtc_threshold,
                gtc_threshold, cttc_threshold, time_decimals)
            rows.append(np.concatenate(([tp, fp], cts_row)))
        base, stats = rows[0], rows[1:]
        out.append((levels,
                    np.asarray(stats, dtype=float).reshape(
                        len(levels), 2 + k),
                    np.asarray(base, dtype=float)))
    return out


def _counts_at_threshold(
        scores_arrays, ground_truth, classes, threshold,
        dtc_threshold, gtc_threshold, cttc_threshold, time_decimals):
    k = len(classes)
    tps = np.zeros(k)
    fps = np.zeros(k)
    cts = np.zeros((k, k))
    for clip_id, (arr, timestamps) in scores_arrays.items():
        gt = ground_truth.get(clip_id, [])
        gt_by_class = {}
        for on, off, lb in gt:
            gt_by_class.setdefault(lb, []).append((on, off))
        detections = event_list_from_score_array(
            arr, timestamps, classes, threshold)
        det_by_class = {}
        for on, off, lb in detections:
            det_by_class.setdefault(lb, []).append((on, off))
        for ki, c in enumerate(classes):
            tp, fp, cts_row = _class_counts(
                det_by_class.get(c, []), gt_by_class, classes, ki,
                dtc_threshold, gtc_threshold, cttc_threshold,
                time_decimals)
            tps[ki] += tp
            fps[ki] += fp
            cts[ki] += cts_row
    return tps, fps, cts


def psds(scores, ground_truth, audio_durations, *, dtc_threshold,
         gtc_threshold, cttc_threshold=None, alpha_ct=0., alpha_st=0.,
         unit_of_time='hour', max_efpr=100., time_decimals=6,
         thresholds=None, num_jobs=1):
    """Returns (psds_value, (efpr_grid, etpr_curve), classwise_rocs).

    Default (``thresholds=None``): EXACT per-class ROCs over ALL distinct
    score values (change-point enumeration, the reference's
    sed_scores_eval semantics). Pass an explicit threshold grid for the
    approximate path (:func:`approximate_psds` uses the official
    50-threshold grid).

    ``classwise_rocs``: {class: (tpr, efpr, thresholds)}.
    """
    from pathlib import Path
    if isinstance(ground_truth, (str, Path)):
        from pb_sed_tpu_torch.evaluation.scores import read_ground_truth_events
        ground_truth = read_ground_truth_events(ground_truth)
    if isinstance(audio_durations, (str, Path)):
        from pb_sed_tpu_torch.evaluation.scores import read_audio_durations
        audio_durations = read_audio_durations(audio_durations)
    classes = None
    scores_arrays = {}
    for clip_id in scores:
        timestamps, classes = validate_score_dataframe(
            scores[clip_id], classes)
        scores_arrays[clip_id] = (
            scores[clip_id][classes].to_numpy(), timestamps)
    k = len(classes)
    n_ref = np.zeros(k)
    t_ref = np.zeros(k)  # total gt duration per class (unit_of_time)
    unit = SECONDS_PER_UNIT[unit_of_time]
    for clip_id, gt in ground_truth.items():
        for on, off, lb in gt:
            if lb in classes:
                ki = classes.index(lb)
                n_ref[ki] += 1
                t_ref[ki] += (off - on) / unit
    dataset_duration = sum(audio_durations.values()) / unit

    def efpr_of(fps, cts):
        """cts: (..., k) cross-trigger counts of this class's invalid
        detections against every other class."""
        efpr = fps / max(dataset_duration, 1e-12)
        if alpha_ct > 0. and cttc_threshold is not None and k > 1:
            ctr = cts / np.maximum(t_ref, 1e-12)
            efpr = efpr + alpha_ct * ctr.sum(-1) / (k - 1)
        return efpr

    from pb_sed_tpu_torch.evaluation.parallel import parallel_map
    classwise_rocs = {}
    if thresholds is None:
        # exact path: per-clip change-point staircases, delta-merged
        from pb_sed_tpu_torch.evaluation.changepoints import (
            CurveAccumulator, representative_thresholds)
        items = [
            (clip_id, arr, timestamps)
            for clip_id, (arr, timestamps) in scores_arrays.items()
        ]
        contributions = parallel_map(
            _psds_clip_job, items,
            (ground_truth, classes, dtc_threshold, gtc_threshold,
             cttc_threshold, time_decimals),
            num_jobs=num_jobs)
        for ki, c in enumerate(classes):
            acc = CurveAccumulator(2 + k)
            for contrib in contributions:
                levels, stats, base = contrib[ki]
                acc.add(levels, stats, base)
            bps, curve = acc.merged()
            reps = representative_thresholds(bps)
            tpr = curve[:, 0] / max(n_ref[ki], 1)
            # own-class column of cts is always zero (no self triggers)
            efpr = efpr_of(curve[:, 1], curve[:, 2:])
            order = np.argsort(efpr, kind='mergesort')
            classwise_rocs[c] = (
                np.maximum.accumulate(tpr[order]), efpr[order],
                reps[order])
    else:
        thresholds = np.asarray(thresholds, dtype=float)
        tprs = np.zeros((len(thresholds), k))
        efprs = np.zeros((len(thresholds), k))
        all_counts = parallel_map(
            _counts_job, [float(t) for t in thresholds],
            (scores_arrays, ground_truth, classes, dtc_threshold,
             gtc_threshold, cttc_threshold, time_decimals),
            num_jobs=num_jobs)
        for ti, (tps, fps, cts) in enumerate(all_counts):
            tprs[ti] = tps / np.maximum(n_ref, 1)
            np.fill_diagonal(cts, 0.)
            efprs[ti] = efpr_of(fps, cts)
        classwise_rocs = _classwise_rocs_from_grid(
            tprs, efprs, thresholds, classes)

    value, (grid, etpr) = _psds_from_rocs(
        classwise_rocs, classes, alpha_st, max_efpr)
    return value, (grid, etpr), classwise_rocs


def _classwise_rocs_from_grid(tprs, efprs, thresholds, classes):
    """(T, K) tpr/efpr arrays over a shared threshold grid -> per-class
    ROC tuples (tpr monotone-staircase over efpr-sorted points)."""
    classwise = {}
    for ki, c in enumerate(classes):
        order = np.argsort(efprs[:, ki], kind='mergesort')
        classwise[c] = (
            np.maximum.accumulate(tprs[order, ki]),
            efprs[order, ki], thresholds[order])
    return classwise


def _psds_from_rocs(classwise_rocs, classes, alpha_st, max_efpr):
    """Across-class effective TPR over the union of efpr support points
    -> normalized staircase AUC."""
    k = len(classes)
    grid = np.unique(np.concatenate(
        [roc[1] for roc in classwise_rocs.values()] + [[0.]]))
    if max_efpr is not None:
        grid = np.concatenate((grid[grid < max_efpr], [max_efpr]))
    tpr_at = np.zeros((k, len(grid)))
    for ki, c in enumerate(classes):
        t, e, _ = classwise_rocs[c]
        # staircase value: max tpr among points with efpr <= g
        idx = np.searchsorted(e, grid, side='right') - 1
        tpr_at[ki] = np.where(idx >= 0, t[np.clip(idx, 0, None)], 0.)
    etpr = tpr_at.mean(0) - alpha_st * tpr_at.std(0)
    etpr = np.maximum(etpr, 0.)
    value = staircase_auc(etpr, grid, max_efpr) / max_efpr
    return value, (grid, etpr)


def psds_from_operating_points(operating_points, ground_truth,
                               audio_durations, *, dtc_threshold,
                               gtc_threshold, cttc_threshold=None,
                               alpha_ct=0., alpha_st=0.,
                               unit_of_time='hour', max_efpr=100.):
    """PSDS from explicit per-threshold detection event lists.

    Args:
        operating_points: {threshold: {clip_id: [(onset, offset, label)]}}.

    Used for the "from files" self-consistency check: detections written
    per threshold (``write_detections_for_multiple_thresholds``) are read
    back and must reproduce the in-memory PSDS
    (reference ``experiments/weak_label_crnn/inference.py:326-355``).
    """
    unit = SECONDS_PER_UNIT[unit_of_time]
    classes = sorted({
        label
        for detections in operating_points.values()
        for events in detections.values()
        for *_, label in events
    } | {label for gt in ground_truth.values() for *_, label in gt})
    k = len(classes)
    n_ref = np.zeros(k)
    t_ref = np.zeros(k)
    for gt in ground_truth.values():
        for on, off, label in gt:
            if label in classes:
                ki = classes.index(label)
                n_ref[ki] += 1
                t_ref[ki] += (off - on) / unit
    dataset_duration = sum(audio_durations.values()) / unit
    thresholds = sorted(operating_points.keys())
    tprs = np.zeros((len(thresholds), k))
    efprs = np.zeros((len(thresholds), k))
    for ti, thr in enumerate(thresholds):
        detections = operating_points[thr]
        tps = np.zeros(k)
        fps = np.zeros(k)
        cts = np.zeros((k, k))
        for clip_id, events in detections.items():
            gt = ground_truth.get(clip_id, [])
            gt_by_class = {}
            for on, off, lb in gt:
                gt_by_class.setdefault(lb, []).append((on, off))
            det_by_class = {}
            for on, off, lb in events:
                det_by_class.setdefault(lb, []).append((on, off))
            for ki in range(k):
                tp, fp, cts_row = _class_counts(
                    det_by_class.get(classes[ki], []), gt_by_class,
                    classes, ki, dtc_threshold, gtc_threshold,
                    cttc_threshold, None)
                tps[ki] += tp
                fps[ki] += fp
                cts[ki] += cts_row
        tprs[ti] = tps / np.maximum(n_ref, 1)
        efpr = fps / max(dataset_duration, 1e-12)
        if alpha_ct > 0. and cttc_threshold is not None and k > 1:
            ctr = cts / np.maximum(t_ref[None, :], 1e-12)
            np.fill_diagonal(ctr, 0.)
            efpr = efpr + alpha_ct * ctr.sum(-1) / (k - 1)
        efprs[ti] = efpr
    classwise = _classwise_rocs_from_grid(
        tprs, efprs, np.asarray(thresholds), classes)
    value, (grid, etpr) = _psds_from_rocs(
        classwise, classes, alpha_st, max_efpr)
    return value, (grid, etpr), classwise


def approximate_psds_from_detections_dir(
        detections_dir, ground_truth, audio_durations, *,
        dtc_threshold=.7, gtc_threshold=.7, cttc_threshold=None,
        alpha_ct=0., alpha_st=0., unit_of_time='hour', max_efpr=100.,
        thresholds=None, num_jobs=1):
    """Approximate PSDS re-computed from on-disk per-threshold detection
    TSVs (cross-check of the score-IO round trip)."""
    del num_jobs
    from pathlib import Path
    from pb_sed_tpu_torch.evaluation.scores import read_ground_truth_events
    if isinstance(ground_truth, (str, Path)):
        ground_truth = read_ground_truth_events(ground_truth)
    operating_points = {}
    for tsv in sorted(Path(detections_dir).glob('*.tsv')):
        try:
            thr = float(tsv.stem)
        except ValueError:
            continue
        operating_points[thr] = read_ground_truth_events(tsv)
    return psds_from_operating_points(
        operating_points, ground_truth, audio_durations,
        dtc_threshold=dtc_threshold, gtc_threshold=gtc_threshold,
        cttc_threshold=cttc_threshold, alpha_ct=alpha_ct,
        alpha_st=alpha_st, unit_of_time=unit_of_time, max_efpr=max_efpr)


def approximate_psds(scores, ground_truth, audio_durations, *,
                     thresholds=None, dtc_threshold=.7, gtc_threshold=.7,
                     cttc_threshold=None, alpha_ct=0., alpha_st=0.,
                     unit_of_time='hour', max_efpr=100., num_jobs=1):
    """The psds_eval-compatible 50-threshold approximation
    (reference cross-check path, ``inference.py:326-355``).

    Returns (psds_value, (efpr_grid, etpr), classwise_rocs) like
    :func:`psds`."""
    if thresholds is None:
        thresholds = DEFAULT_THRESHOLDS
    return psds(
        scores, ground_truth, audio_durations,
        dtc_threshold=dtc_threshold, gtc_threshold=gtc_threshold,
        cttc_threshold=cttc_threshold, alpha_ct=alpha_ct,
        alpha_st=alpha_st, unit_of_time=unit_of_time, max_efpr=max_efpr,
        thresholds=thresholds, num_jobs=num_jobs)
