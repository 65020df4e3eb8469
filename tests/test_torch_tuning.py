"""The port's tuning, pseudo-labeling and score-frame conversion
(``pb_sed_tpu_torch/models/base/{tuning,pseudo_label,inference}.py``)
against the JAX package's on the same score dicts (pandas frames for the
JAX side, the port's ``ScoreFrame``s for the port): the three ``tune_*``
write the same ``*_hyper_params_*.json`` bytes and keep the same
leaderboards, ``pseudo_label`` gives the same dataset dict, and
``scores_to_dataframes`` and the inference engine's frame output (with and
without score files) give the same frames and the same files. All values
are compared for equality (the same numpy operations in the same order).
"""
import functools

import numpy as np
import pytest

from pb_sed_tpu.models import base as jbase
from pb_sed_tpu_torch.models import base as tbase
from tests.test_torch_evaluation import (CLASSES, SCENARIO_1, _data,
                                         _frames, _tagging_frames,
                                         assert_same)


@pytest.fixture(scope='module')
def data():
    arrays, timestamps, events, tags, durations = _data(seed=1, n_clips=5)
    jframes, tframes = _frames(arrays, timestamps)
    jtag, ttag = _tagging_frames(arrays, durations)
    masks = {c: np.isin(CLASSES, tags[c]) for c in arrays}
    return dict(arrays=arrays, timestamps=timestamps, events=events,
                tags=tags, durations=durations, jframes=jframes,
                tframes=tframes, jtag=jtag, ttag=ttag, masks=masks)


def _frame_values(frames):
    """{clip: (columns, values)} of a dict of either package's frames."""
    return {clip: (list(f.columns), f.to_numpy())
            for clip, f in frames.items()}


def _same_leaderboards(got, ref):
    assert list(got) == list(ref)
    for metric in ref:
        tvalues, tparams, tscores = got[metric]
        jvalues, jparams, jscores = ref[metric]
        assert_same(tvalues, jvalues)
        assert_same(tparams, jparams)
        assert_same(_frame_values(tscores), _frame_values(jscores))


def _same_files(tmp_path, names):
    for name in names:
        assert ((tmp_path / 'port' / name).read_bytes()
                == (tmp_path / 'jax' / name).read_bytes()), name


def test_tune_tagging_writes_the_same_hyper_params(data, tmp_path):
    runs = {}
    for pkg, frames, name in ((jbase, data['jtag'], 'jax'),
                              (tbase, data['ttag'], 'port')):
        metrics = {'f': functools.partial(pkg.f_tag,
                                          ground_truth=data['tags'])}
        runs[name] = pkg.tune_tagging(
            frames, medfilt_length_candidates=[1], metrics=metrics,
            storage_dir=tmp_path / name)
    _same_leaderboards(runs['port'], runs['jax'])
    _same_files(tmp_path, ['tagging_hyper_params_f.json'])


def test_tune_boundaries_detection_writes_the_same_hyper_params(
        data, tmp_path):
    runs = {}
    for pkg, frames, name in ((jbase, data['jframes'], 'jax'),
                              (tbase, data['tframes'], 'port')):
        metrics = {'f': functools.partial(
            pkg.f_collar,
            ground_truth=pkg.boundaries_from_events(data['events']),
            onset_collar=.5, offset_collar=.5, offset_collar_rate=0.,
            min_precision=.5, return_onset_offset_bias=True)}
        runs[name] = pkg.tune_boundaries_detection(
            frames, medfilt_length_candidates=[1, 3],
            stepfilt_length_candidates=[0, 4], tags=data['masks'],
            metrics=metrics, tag_masking='?', storage_dir=tmp_path / name)
    _same_leaderboards(runs['port'], runs['jax'])
    _same_files(tmp_path, ['boundaries_detection_hyper_params_f.json'])


def test_tune_sound_event_detection_writes_the_same_hyper_params(
        data, tmp_path):
    runs = {}
    for pkg, frames, name in ((jbase, data['jframes'], 'jax'),
                              (tbase, data['tframes'], 'port')):
        metrics = {
            'f': functools.partial(
                pkg.f_collar, ground_truth=data['events'],
                onset_collar=.2, offset_collar=.2, offset_collar_rate=.2,
                return_onset_offset_bias=True),
            'auc': functools.partial(
                pkg.psd_auc, ground_truth=data['events'],
                audio_durations=data['durations'], **SCENARIO_1),
        }
        runs[name] = pkg.tune_sound_event_detection(
            frames, [1, 5], data['masks'], metrics=metrics,
            tag_masking={'f': True, 'auc': '?'},
            storage_dir=tmp_path / name)
    _same_leaderboards(runs['port'], runs['jax'])
    _same_files(tmp_path, ['sed_hyper_params_f.json',
                           'sed_hyper_params_auc.json'])
    params = runs['port']['auc'][1]
    assert {p['medfilt_length'] for p in params.values()} <= {1, 5}


def test_update_leaderboard_keeps_copies(data):
    """A class's winning scores are copied into the leaderboard's frames;
    changing the candidate frames afterwards does not reach them (the
    port's frames share no memory, as pandas' do not)."""
    frames = data['tframes']
    board = tbase.update_leaderboard(
        {}, 'f', {c: .5 for c in CLASSES},
        {c: {'medfilt_length': 1} for c in CLASSES}, frames)
    candidate = {clip: tbase.scores_to_dataframes(
        np.full((60, 3), .9), data['timestamps'], CLASSES)
        for clip in frames}
    board = tbase.update_leaderboard(
        board, 'f', {'Dog': .2, 'Cat': .7, 'Speech': .5},
        {c: {'medfilt_length': 3} for c in CLASSES}, candidate)
    values, params, scores = board['f']
    assert values['macro_average'] == pytest.approx((.5 + .7 + .5) / 3)
    assert [params[c]['medfilt_length'] for c in CLASSES] == [1, 3, 3]
    for clip in frames:
        candidate[clip]['Cat'] = 0.
        np.testing.assert_array_equal(scores[clip]['Cat'], .9)
        np.testing.assert_array_equal(scores[clip]['Dog'],
                                      frames[clip]['Dog'])


def test_pseudo_label_gives_the_same_dataset(data):
    dataset = {
        clip: {'audio_length': data['durations'][clip],
               'events': list(data['tags'][clip])}
        for clip in data['arrays']}
    tags = {c: a.max(0) for c, a in data['arrays'].items()}
    events = {c: [(on + .1, off, lb) for on, off, lb in evs]
              for c, evs in data['events'].items()}
    boundaries = jbase.boundaries_from_events(events)
    for flags in ((True, False, True), (True, True, False),
                  (False, False, True)):
        got = tbase.pseudo_label(dataset, CLASSES, *flags, tags,
                                 boundaries, events)
        ref = jbase.pseudo_label(dataset, CLASSES, *flags, tags,
                                 boundaries, events)
        assert got == ref
    assert got is not dataset and dataset['clip0'].get(
        'events_start_times') is None


@pytest.mark.parametrize('shape', ['clip', 'clips', 'paramsets'])
@pytest.mark.parametrize('stored', [False, True])
def test_scores_to_dataframes(data, tmp_path, shape, stored):
    """One (T, K) array, a dict of them, and a dict of per-paramset
    (N, T, K) stacks, each with and without score files: the same frames
    and the same file bytes as the JAX package's. With files, the lazy
    loaders over them read back the frames made without files; pandas
    reads the JAX side's within 1e-13 of them (its float parser keeps
    about 16 significant digits, ``tests/test_torch_scores.py``)."""
    arrays = data['arrays']
    if shape == 'clip':
        scores = arrays['clip0']
        paths = {name: tmp_path / name / 'clip0.tsv'
                 for name in ('jax', 'port')}
    elif shape == 'clips':
        scores = arrays
        paths = {name: tmp_path / name for name in ('jax', 'port')}
    else:
        scores = {c: np.stack([a, a ** 2]) for c, a in arrays.items()}
        paths = {name: [tmp_path / name / 'f', tmp_path / name / 'psds1']
                 for name in ('jax', 'port')}
    got = tbase.scores_to_dataframes(
        scores, data['timestamps'], CLASSES,
        paths['port'] if stored else None)
    ref = jbase.scores_to_dataframes(
        scores, data['timestamps'], CLASSES,
        paths['jax'] if stored else None)
    if shape == 'clip':
        got, ref = [{'clip0': got}], [{'clip0': ref}]
    elif shape == 'clips':
        got, ref = [got], [ref]
    if stored and shape != 'clip':  # an array's frame is not read back
        unstored = tbase.scores_to_dataframes(scores, data['timestamps'],
                                              CLASSES)
        unstored = [unstored] if shape == 'clips' else unstored
        _same_or_parsed(got, ref, unstored)
    else:
        _same_or_parsed(got, ref)
    if stored:
        jax_files = sorted((tmp_path / 'jax').rglob('*.tsv'))
        assert len(jax_files) == {'clip': 1, 'clips': 5, 'paramsets': 10}[
            shape]
        for path in jax_files:
            port = tmp_path / 'port' / path.relative_to(tmp_path / 'jax')
            assert port.read_bytes() == path.read_bytes()
        if shape != 'clip':
            assert all(type(g).__name__ == 'lazy_sed_scores_loader'
                       for g in got)


def _same_or_parsed(got, ref, unstored=None):
    """``got`` equals ``ref`` (lists of {clip: frame}); with ``unstored``
    (the frames the port makes without files) ``got`` equals that, and
    ``ref``, read back by pandas, is within 1e-13 of it."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert sorted(g) == sorted(r)
        got_values = _frame_values({c: g[c] for c in sorted(g)})
        ref_values = _frame_values({c: r[c] for c in sorted(r)})
        if unstored is None:
            assert_same(got_values, ref_values)
            continue
        assert_same(got_values, _frame_values(
            {c: unstored[i][c] for c in sorted(g)}))
        for clip, (columns, values) in ref_values.items():
            assert columns == got_values[clip][0]
            np.testing.assert_allclose(values, got_values[clip][1],
                                       rtol=1e-13, atol=1e-300)


class _Scores:
    """A model stand-in for the inference engines: ``dispatch`` and the
    method return fixed (B, K, T) scores of the batch's clips."""

    module = None

    def __init__(self, arrays):
        self.arrays = arrays

    def sound_event_detection(self, batch, **params):
        y = np.stack([self.arrays[c].T for c in batch['example_id']])
        return y, np.asarray(batch['seq_len'])

    def dispatch(self, method, batch, **params):
        return getattr(self, method)(batch, **params)


def test_engine_score_frames_match_jax(data, tmp_path):
    """The engine with ``timestamps`` and ``event_classes``, per-paramset
    median filters (a (2, K) array) and tag masks, without and with
    ``score_storage_dir``: the same frames (lists of dicts, lists of
    loaders) and files as the JAX engine's."""
    arrays = data['arrays']
    clips = sorted(arrays)
    batches = [{'example_id': clips[i:i + 2],
                'seq_len': np.array([60] * len(clips[i:i + 2])),
                'audio_data': np.zeros((len(clips[i:i + 2]), 10))}
               for i in range(0, len(clips), 2)]
    kwargs = dict(medfilt_length=np.array([[1, 3, 1], [5, 5, 3]]),
                  apply_mask=np.array([[True, False, True]] * 2),
                  masks=data['masks'], timestamps=data['timestamps'],
                  event_classes=CLASSES)
    unstored = None
    for stored in (False, True):
        dirs = {name: ([tmp_path / name / 'f', tmp_path / name / 'psds1']
                       if stored else None) for name in ('jax', 'port')}
        ref = jbase.sound_event_detection(
            _Scores(arrays), batches, auto_stack=False, mesh=None,
            score_storage_dir=dirs['jax'], **kwargs)
        got = tbase.sound_event_detection(
            _Scores(arrays), batches, score_storage_dir=dirs['port'],
            **kwargs)
        assert len(got) == len(ref) == 2
        assert all(sorted(g) == clips for g in got)
        _same_or_parsed(got, ref, unstored)
        unstored = got
    for path in sorted((tmp_path / 'jax').rglob('*.tsv')):
        port = tmp_path / 'port' / path.relative_to(tmp_path / 'jax')
        assert port.read_bytes() == path.read_bytes()
