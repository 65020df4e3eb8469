"""Inference engine: tagging, boundaries detection and sound event
detection by one model or the mean of several.

Counterpart of ``pb_sed_tpu/models/base/inference.py``: one generic
``inference(models, method, dataset, ...)`` plus the three wrappers;
member mean (members run in turn), sequence masking, per-class /
per-paramset median filtering, ``boundariesfilt`` step filtering, tag
masks and overlapped segment merging. Scores come back as
``{example_id: (T, K) numpy array}`` (per-paramset ``(N, T, K)``), or,
given ``timestamps`` and ``event_classes``, as score frames
(``evaluation.scores.ScoreFrame``, the port's pandas-free table;
per-paramset: a list of dicts), written to ``score_storage_dir`` and
read back lazily where one is given (``scores_to_dataframes``).

Model calls are launched one segment ahead (``model.dispatch`` returns
device tensors before the device is done), so the host post-processing
of one segment overlaps the device work on the next. With ``auto_stack``
(the default) the members of an ensemble that share one architecture and
one set of ``model_kwargs`` are served stacked
(``models/base/ensemble.py``: one launch per layer for all members, as
the JAX engine's one program); others run in turn.
"""
from pathlib import Path

import numpy as np

from pb_sed_tpu_torch.evaluation.scores import (
    create_score_dataframe, lazy_sed_scores_loader, write_sed_scores)
from pb_sed_tpu_torch.models.base.model import to_numpy
from pb_sed_tpu_torch.ops.filters import boundariesfilt, medfilt
from pb_sed_tpu_torch.parallel.mesh import default_ensemble_mesh
from pb_sed_tpu_torch.utils.segment import merge_segments, segment_batch


def tagging(models, dataset, max_segment_length=None, segment_overlap=None,
            merge_score_segments=False, score_segment_overlap=None,
            model_kwargs=None, medfilt_length=1, method='tagging',
            timestamps=None, event_classes=None, score_storage_dir=None,
            device=None, auto_stack=True, mesh='auto'):
    return inference(
        models, method, dataset, auto_stack=auto_stack, mesh=mesh,
        max_segment_length=max_segment_length,
        segment_overlap=segment_overlap,
        merge_score_segments=merge_score_segments,
        score_segment_overlap=score_segment_overlap,
        model_kwargs=model_kwargs, medfilt_length=medfilt_length,
        post_processing_fn=lambda x: x.max(-2, keepdims=True),
        timestamps=timestamps, event_classes=event_classes,
        score_storage_dir=score_storage_dir)


def boundaries_detection(models, dataset, max_segment_length=None,
                         segment_overlap=None, merge_score_segments=False,
                         score_segment_overlap=None, model_kwargs=None,
                         medfilt_length=1, stepfilt_length=0,
                         apply_mask=False, masks=None,
                         method='boundaries_detection', timestamps=None,
                         event_classes=None, score_storage_dir=None,
                         device=None, auto_stack=True, mesh='auto'):
    return inference(
        models, method, dataset, auto_stack=auto_stack, mesh=mesh,
        max_segment_length=max_segment_length,
        segment_overlap=segment_overlap,
        merge_score_segments=merge_score_segments,
        score_segment_overlap=score_segment_overlap,
        model_kwargs=model_kwargs, medfilt_length=medfilt_length,
        stepfilt_length=stepfilt_length, apply_mask=apply_mask,
        masks=masks, timestamps=timestamps, event_classes=event_classes,
        score_storage_dir=score_storage_dir)


def sound_event_detection(models, dataset, max_segment_length=None,
                          segment_overlap=None, merge_score_segments=False,
                          score_segment_overlap=None, model_kwargs=None,
                          medfilt_length=1,
                          method='sound_event_detection',
                          apply_mask=False, masks=None, timestamps=None,
                          event_classes=None, score_storage_dir=None,
                          device=None, auto_stack=True, mesh='auto'):
    return inference(
        models, method, dataset, auto_stack=auto_stack, mesh=mesh,
        max_segment_length=max_segment_length,
        segment_overlap=segment_overlap,
        merge_score_segments=merge_score_segments,
        score_segment_overlap=score_segment_overlap,
        model_kwargs=model_kwargs, medfilt_length=medfilt_length,
        apply_mask=apply_mask, masks=masks, timestamps=timestamps,
        event_classes=event_classes, score_storage_dir=score_storage_dir)


def inference(model, method, dataset, max_segment_length=None,
              segment_overlap=0, merge_score_segments=False,
              score_segment_overlap=None, model_kwargs=None,
              medfilt_length=1, stepfilt_length=None, apply_mask=False,
              masks=None, post_processing_fn=None, timestamps=None,
              event_classes=None, score_storage_dir=None, device=None,
              auto_stack=True, mesh='auto'):
    """Run ``method`` of one model (or the mean of a list of models) over
    the batches of ``dataset`` and post-process the scores per clip.

    ``auto_stack`` serves several models of one architecture and one set
    of ``model_kwargs`` as one ``StackedEnsemble`` (a failure there
    raises; ``auto_stack=False`` runs the members in turn).
    ``mesh='auto'`` (the JAX default) is
    ``parallel.mesh.default_ensemble_mesh(len(models))``: ``None`` in a
    process without a process group or at world 1 (this process's
    device), else the members over an ``ensemble`` axis and the batch
    over ``data`` of the ranks, every rank running this call on the same
    dataset and getting the whole scores; ``mesh=None`` forces this
    process's device, and a ``parallel.mesh.Mesh`` is taken as given.
    ``device`` is accepted as in the JAX package and unused: the models'
    device decides."""
    models = model if isinstance(model, (list, tuple)) else [model]
    if model_kwargs is None:
        model_kwargs = {}
    if not isinstance(model_kwargs, (list, tuple)):
        model_kwargs = len(models) * [model_kwargs]
    if len(model_kwargs) != len(models):
        raise ValueError(f'{len(model_kwargs)} model_kwargs for '
                         f'{len(models)} models')
    if auto_stack and len(models) > 1:
        from pb_sed_tpu_torch.models.base.ensemble import maybe_stack
        if isinstance(mesh, str) and mesh == 'auto':
            mesh = default_ensemble_mesh(len(models))
        models, model_kwargs = maybe_stack(list(models), list(model_kwargs),
                                           mesh=mesh)
    medfilt_length = np.asarray(medfilt_length, dtype=int)
    apply_mask = np.asarray(apply_mask, dtype=bool)
    for m in models:
        if not hasattr(m, method):
            raise AttributeError(f'{type(m).__name__} has no {method!r}')
    stft_geom = getattr(
        getattr(models[0].module, 'feature_extractor', None), 'stft', None)
    if post_processing_fn is None:
        def post_processing_fn(x):
            return x
    if stepfilt_length is not None:
        stepfilt_length = np.asarray(stepfilt_length, dtype=int)
    scores = {}
    score_cache = {}

    def segments():
        """(segment, last_of_batch) over the dataset's batches."""
        for batch in dataset:
            batch = dict(batch)
            for key in ('weak_targets', 'boundary_targets',
                        'strong_targets'):
                batch.pop(key, None)
            if max_segment_length is not None:
                input_segments = segment_batch(
                    batch, max_length=max_segment_length,
                    overlap=segment_overlap, stft=stft_geom)
            else:
                input_segments = [batch]
            for j, segment in enumerate(input_segments):
                yield segment, j == len(input_segments) - 1

    def finalize(segment, outs, last_of_batch):
        """Host side of one segment: member mean, mask, filter, cache;
        on the last segment of a batch, merge and hand over."""
        nonlocal scores, score_cache
        segment_scores = None
        seq_len = None
        for yi, seq_len_i in outs:
            yi = to_numpy(yi).astype(np.float64)
            seq_len_i = to_numpy(seq_len_i)
            if segment_scores is None:
                segment_scores, seq_len = yi, seq_len_i
            else:
                if not (seq_len_i == seq_len).all():
                    raise ValueError(f'members disagree on lengths: '
                                     f'{seq_len} vs {seq_len_i}')
                segment_scores = segment_scores + yi
        segment_scores = segment_scores / len(models)
        # sequence masking (scores are (B, ..., K, T))
        t = segment_scores.shape[-1]
        mask = (np.arange(t)[None, :]
                < seq_len[:, None]).astype(segment_scores.dtype)
        mask = mask.reshape(
            mask.shape[0], *([1] * (segment_scores.ndim - 2)), t)
        segment_scores = filtering(segment_scores * mask, medfilt,
                                   medfilt_length)
        if stepfilt_length is not None:
            segment_scores = filtering(
                segment_scores, boundariesfilt, stepfilt_length)
        score_cache.update({
            audio_id: post_processing_fn(
                segment_scores[i, ..., :sl].swapaxes(-2, -1))
            for i, (audio_id, sl) in enumerate(zip(
                segment['example_id'], seq_len))
        })
        if apply_mask.any():
            if masks is None:
                raise ValueError('apply_mask needs masks')
            for audio_id in segment['example_id']:
                # tag masks are keyed by clip id (time-invariant)
                mask_key = audio_id.split('_!segment!_')[0]
                m_arr = apply_mask
                if m_arr.ndim == 2:
                    m_arr = m_arr[..., None, :]
                score_cache[audio_id] = score_cache[audio_id] * (
                    np.maximum(masks[mask_key], 1 - m_arr))
        if not last_of_batch:
            return
        local_cache = score_cache
        if merge_score_segments:
            example_id = segment['example_id'][0]
            if '_!segment!_' in example_id:
                seg_idx, n_segments = example_id.split(
                    '_!segment!_')[-1].split('_')
                if int(seg_idx) != int(n_segments) - 1:
                    return  # batch ends mid-clip: keep accumulating
                local_cache = merge_segments(
                    local_cache,
                    segment_overlap=segment_overlap
                    if score_segment_overlap is None
                    else score_segment_overlap)
        if (timestamps is not None or event_classes is not None
                or score_storage_dir is not None):
            if timestamps is None or event_classes is None:
                raise ValueError('score frames need both timestamps and '
                                 'event_classes')
            local_cache = scores_to_dataframes(
                local_cache, timestamps, event_classes, score_storage_dir)
        if score_storage_dir is None:
            if not scores:
                scores = local_cache
            elif isinstance(scores, (list, tuple)):
                for i in range(len(scores)):
                    scores[i].update(local_cache[i])
            else:
                scores.update(local_cache)
        else:
            scores = local_cache
        score_cache = {}

    pending = None
    for segment, last_of_batch in segments():
        outs = [m.dispatch(method, segment, **model_kwargs[i])
                for i, m in enumerate(models)]
        if pending is not None:
            finalize(*pending)
        pending = (segment, outs, last_of_batch)
    if pending is not None:
        finalize(*pending)
    return scores


def filtering(score_arr, filter_fn, filter_length):
    """Apply a time filter with scalar / per-class / per-paramset
    lengths."""
    score_arr = np.array(score_arr)
    b, *_, k, t = score_arr.shape
    filter_length = np.asarray(filter_length, dtype=int)
    if filter_length.ndim == 0:
        return filter_fn(score_arr, int(filter_length), axis=-1)
    if filter_length.ndim == 1:
        if filter_length.shape[0] != k:
            raise ValueError(f'{filter_length.shape} lengths for {k} classes')
        for ki, n in enumerate(filter_length):
            score_arr[..., ki, :] = filter_fn(
                score_arr[..., ki, :], int(n), axis=-1)
        return score_arr
    if filter_length.ndim == 2:
        if filter_length.shape[1] not in (1, k):
            raise ValueError(f'{filter_length.shape} lengths for {k} classes')
        n_sets = filter_length.shape[0]
        if score_arr.ndim == 3:
            score_arr = np.broadcast_to(
                score_arr[:, None], (b, n_sets, k, t)).copy()
        elif score_arr.shape[1] != n_sets:
            raise ValueError(f'{score_arr.shape} scores for {n_sets} sets')
        for j in range(n_sets):
            if filter_length.shape[1] == 1:
                score_arr[:, j] = filter_fn(
                    score_arr[:, j], int(filter_length[j, 0]), axis=-1)
            else:
                for ki in range(k):
                    score_arr[:, j, ki] = filter_fn(
                        score_arr[:, j, ki], int(filter_length[j, ki]),
                        axis=-1)
        return score_arr
    raise ValueError(filter_length.shape)


def scores_to_dataframes(scores, timestamps, event_classes,
                         storage_path=None):
    """(T, K) arrays (or dicts / per-paramset stacks) -> score frames.

    A (T, K) array gives one frame over ``timestamps[:T + 1]``, written to
    the file ``storage_path`` where one is given. A dict ``{audio_id:
    (T, K)}`` gives ``{audio_id: frame}`` (``timestamps`` one array or a
    dict by audio id); with a directory ``storage_path`` each frame goes
    to ``<dir>/<audio_id>.tsv`` and a ``lazy_sed_scores_loader`` of the
    directory comes back. A dict of per-paramset stacks ``(N, T, K)``
    gives a list of N such dicts, or with a list of N directories a list
    of N loaders.
    """
    if isinstance(scores, np.ndarray):
        t, k = scores.shape
        assert len(timestamps) > t, (len(timestamps), t)
        assert len(event_classes) == k, (event_classes, k)
        df = create_score_dataframe(
            scores, np.asarray(timestamps)[:t + 1], event_classes)
        if storage_path is not None:
            write_sed_scores(df, storage_path)
        return df
    assert isinstance(scores, dict), type(scores)
    audio_ids = sorted(scores.keys())
    if not audio_ids:
        return {}
    first = scores[audio_ids[0]]
    if np.ndim(first) == 3:
        n = np.shape(first)[0]
        out = [dict() for _ in range(n)]
        for audio_id in audio_ids:
            ts = (timestamps[audio_id]
                  if isinstance(timestamps, dict) else timestamps)
            for i in range(n):
                if storage_path is None:
                    filepath = None
                else:
                    assert isinstance(storage_path, (list, tuple))
                    assert len(storage_path) == n
                    d = Path(storage_path[i])
                    d.mkdir(parents=True, exist_ok=True)
                    filepath = d / f'{audio_id}.tsv'
                out[i][audio_id] = scores_to_dataframes(
                    scores[audio_id][i], ts, event_classes, filepath)
        if storage_path is not None:
            return [lazy_sed_scores_loader(p) for p in storage_path]
        return out
    out = {}
    for audio_id in audio_ids:
        ts = (timestamps[audio_id]
              if isinstance(timestamps, dict) else timestamps)
        if storage_path is None:
            filepath = None
        else:
            d = Path(storage_path)
            d.mkdir(parents=True, exist_ok=True)
            filepath = d / f'{audio_id}.tsv'
        out[audio_id] = scores_to_dataframes(
            scores[audio_id], ts, event_classes, filepath)
    if storage_path is not None:
        return lazy_sed_scores_loader(storage_path)
    return out
