"""The port's evaluation (``pb_sed_tpu_torch/evaluation/{clip_based,
collar_based,intersection_based,changepoints,parallel}.py``) against the
JAX package's on the same score dicts: clip-level scores, seeded with
numpy, piecewise constant over frames, as pandas frames for the JAX
package and as the port's ``ScoreFrame``s, with seeded ground truth.

Every value must be EQUAL, not close: both packages run the same numpy
operations in the same order on the same float64 inputs (per-clip
contributions are merged in clip order whatever ``num_jobs`` is), so no
tolerance is stated anywhere here. ``num_jobs=2`` (the port's forkserver
pool) gives what ``num_jobs=1`` gives.
"""
import numpy as np
import pytest

from pb_sed_tpu.evaluation import clip_based as jclip
from pb_sed_tpu.evaluation import collar_based as jcollar
from pb_sed_tpu.evaluation import intersection_based as jinter
from pb_sed_tpu.evaluation import scores as jscores
from pb_sed_tpu_torch.evaluation import clip_based as tclip
from pb_sed_tpu_torch.evaluation import collar_based as tcollar
from pb_sed_tpu_torch.evaluation import intersection_based as tinter
from pb_sed_tpu_torch.evaluation import parallel
from pb_sed_tpu_torch.evaluation import scores as tscores

CLASSES = ['Dog', 'Cat', 'Speech']
SCENARIO_1 = dict(dtc_threshold=.7, gtc_threshold=.7, cttc_threshold=None,
                  alpha_ct=0., alpha_st=1.)
SCENARIO_2 = dict(dtc_threshold=.1, gtc_threshold=.1, cttc_threshold=.3,
                  alpha_ct=.5, alpha_st=1.)


def _data(seed=0, n_clips=6, t=60, frame=.1):
    """({clip: (T, K) scores}, timestamps, ground truth events, tags,
    durations): events of each class raise its scores over their frames;
    a noise floor and quantized levels make ties and plateaus."""
    rng = np.random.RandomState(seed)
    timestamps = np.round(np.arange(t + 1) * frame, 6)
    arrays, events, durations = {}, {}, {}
    for i in range(n_clips):
        clip = f'clip{i}'
        scores = .3 * rng.rand(t, len(CLASSES))
        gt = []
        for _ in range(rng.randint(0, 4)):
            k = rng.randint(len(CLASSES))
            on = rng.randint(0, t - 8)
            off = on + rng.randint(4, 20)
            off = min(off, t)
            scores[on:off, k] += .5 + .2 * rng.rand()
            gt.append((float(timestamps[on] + .03 * rng.randn()),
                       float(timestamps[off]), CLASSES[k]))
        arrays[clip] = np.round(np.clip(scores, 0., 1.), 2)
        events[clip] = sorted(gt)
        durations[clip] = float(timestamps[-1])
    tags = {clip: sorted({lb for *_, lb in evs})
            for clip, evs in events.items()}
    return arrays, timestamps, events, tags, durations


def _frames(arrays, timestamps):
    jax_frames = {c: jscores.create_score_dataframe(a, timestamps, CLASSES)
                  for c, a in arrays.items()}
    port_frames = {c: tscores.create_score_dataframe(a, timestamps, CLASSES)
                   for c, a in arrays.items()}
    return jax_frames, port_frames


def _tagging_frames(arrays, durations):
    tagging = {c: a.max(0, keepdims=True) for c, a in arrays.items()}
    out = []
    for pkg in (jscores, tscores):
        out.append({c: pkg.create_score_dataframe(
            a, [0., durations[c]], CLASSES) for c, a in tagging.items()})
    return out


def assert_same(got, ref, path='result'):
    """Exact equality through dicts, lists, tuples and arrays (NaN equal
    to NaN)."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for key in ref:
            assert_same(got[key], ref[key], f'{path}[{key!r}]')
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f'{path}[{i}]')
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref, err_msg=path)
    else:
        assert type(got) is type(ref) or (
            np.isscalar(got) and np.isscalar(ref)), path
        assert got == ref or (got != got and ref != ref), (path, got, ref)


@pytest.fixture(scope='module')
def data():
    arrays, timestamps, events, tags, durations = _data()
    jframes, tframes = _frames(arrays, timestamps)
    jtag, ttag = _tagging_frames(arrays, durations)
    return dict(jframes=jframes, tframes=tframes, events=events, tags=tags,
                durations=durations, jtag=jtag, ttag=ttag)


@pytest.mark.parametrize('threshold', [.4, {'Dog': .35, 'Cat': .5,
                                            'Speech': .62}])
def test_clip_fscore(data, threshold):
    assert_same(tclip.fscore(data['ttag'], data['tags'], threshold),
                jclip.fscore(data['jtag'], data['tags'], threshold))


def test_clip_best_fscore(data):
    got = tclip.best_fscore(data['ttag'], data['tags'])
    assert_same(got, jclip.best_fscore(data['jtag'], data['tags']))
    assert got[0]['macro_average'] > 0


@pytest.mark.parametrize('collars', [
    dict(onset_collar=.2, offset_collar=.2, offset_collar_rate=.2),
    dict(onset_collar=.5, offset_collar=.5, offset_collar_rate=0.)])
def test_collar_fscore_with_biases(data, collars):
    threshold = {'Dog': .45, 'Cat': .5, 'Speech': .55}
    got = tcollar.fscore(data['tframes'], data['events'], threshold,
                         return_onset_offset_dist_sum=True, **collars)
    assert_same(got, jcollar.fscore(
        data['jframes'], data['events'], threshold,
        return_onset_offset_dist_sum=True, **collars))
    assert any(s['onset_dist_sum'] != 0 for s in got[3].values())


@pytest.mark.parametrize('kwargs', [
    dict(), dict(min_precision=.8), dict(max_thresholds=10)])
def test_collar_best_fscore(data, kwargs):
    got = tcollar.best_fscore(data['tframes'], data['events'], **kwargs)
    assert_same(got, jcollar.best_fscore(data['jframes'], data['events'],
                                         **kwargs))


@pytest.mark.parametrize('scenario', [SCENARIO_1, SCENARIO_2])
def test_psds(data, scenario):
    got = tinter.psds(data['tframes'], data['events'], data['durations'],
                      **scenario)
    assert_same(got, jinter.psds(data['jframes'], data['events'],
                                 data['durations'], **scenario))
    assert 0. < got[0] <= 1.


@pytest.mark.parametrize('scenario', [SCENARIO_1, SCENARIO_2])
def test_approximate_psds(data, scenario):
    thresholds = np.linspace(.01, .99, 50)
    got = tinter.approximate_psds(data['tframes'], data['events'],
                                  data['durations'], thresholds=thresholds,
                                  **scenario)
    assert_same(got, jinter.approximate_psds(
        data['jframes'], data['events'], data['durations'],
        thresholds=thresholds, **scenario))


def test_psds_from_detection_files(data, tmp_path):
    """Detections written per threshold by each package, read back and
    scored by each: the files are the same bytes, the PSDS the same."""
    thresholds = np.linspace(.01, .99, 50)
    tscores.write_detections_for_multiple_thresholds(
        data['tframes'], thresholds, tmp_path / 'port')
    jscores.write_detections_for_multiple_thresholds(
        data['jframes'], thresholds, tmp_path / 'jax')
    for path in sorted((tmp_path / 'port').iterdir()):
        assert path.read_bytes() == (tmp_path / 'jax' / path.name
                                     ).read_bytes()
    got = tinter.approximate_psds_from_detections_dir(
        tmp_path / 'port', data['events'], data['durations'], **SCENARIO_2)
    assert_same(got, jinter.approximate_psds_from_detections_dir(
        tmp_path / 'jax', data['events'], data['durations'], **SCENARIO_2))


@pytest.mark.parametrize('max_x', [None, .65, 5.])
def test_staircase_auc(max_x):
    rng = np.random.RandomState(3)
    x = np.round(rng.rand(30), 2)
    y = np.maximum.accumulate(rng.rand(30))
    assert tinter.staircase_auc(y, x, max_x) == \
        jinter.staircase_auc(y, x, max_x)


def test_two_jobs_equal_one(data):
    """The per-clip sweeps on a pool of 2 workers give what the serial
    loop gives, and the pools are counted."""
    parallel.reset_pool_stats()
    for fn, args, kwargs in (
            (tcollar.best_fscore, (data['tframes'], data['events']), {}),
            (tinter.psds, (data['tframes'], data['events'],
                           data['durations']), SCENARIO_2)):
        assert_same(fn(*args, **kwargs, num_jobs=2),
                    fn(*args, **kwargs, num_jobs=1))
    assert parallel.POOL_STATS['pools'] == 2
    assert parallel.POOL_STATS['start_s'] > 0.


def test_stop_pools_stops_the_server_and_a_later_pool_restarts_it():
    """``stop_pools`` ends the forkserver and the resource tracker before
    the caller exits (both are reaped, so their pids are gone); the next
    pool starts them anew and gives the same answer."""
    import os
    from multiprocessing import forkserver, resource_tracker
    expected = [abs(i) for i in range(-4, 4)]
    assert parallel.parallel_map(abs, range(-4, 4), (), num_jobs=2) == expected
    pids = [forkserver._forkserver._forkserver_pid,
            resource_tracker._resource_tracker._pid]
    assert None not in pids
    parallel.stop_pools()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert forkserver._forkserver._forkserver_pid is None
    assert parallel.parallel_map(abs, range(-4, 4), (), num_jobs=2) == expected
    parallel.stop_pools()
