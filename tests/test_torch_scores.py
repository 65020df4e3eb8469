"""The port's pandas-free score frames (``pb_sed_tpu_torch/evaluation/
scores.py``) against the JAX package's pandas ones: the frame's API as the
evaluation, tuning and inference code calls it; a frame's TSV file, byte
for byte the JAX writer's (pandas') for the same float64 arrays; each
package reads the other's files to ``np.array_equal`` arrays; the event
lists, detection files and ground-truth readers (events format with empty
labels, the DESED weak format, durations) give the same values."""
import copy

import numpy as np
import pandas as pd
import pytest

from pb_sed_tpu.evaluation import scores as jscores
from pb_sed_tpu_torch.evaluation import scores as tscores
from pb_sed_tpu_torch.evaluation.scores import ScoreFrame

CLASSES = ['Dog', 'Cat', 'Speech']


def _arrays(seed, t=40):
    rng = np.random.RandomState(seed)
    scores = rng.rand(t, len(CLASSES))
    # values whose shortest repr takes every form: an exponent, 17
    # digits, an exact integer, a negative zero, a subnormal
    scores[:6, 0] = [1e-05, .1 + .2, 1., -0., 5e-324, 123456789.125]
    timestamps = np.round(np.arange(t + 1) * .02, 6)
    timestamps[-1] = 1 / 3 * 2.4
    return scores, timestamps


def _pair(seed, t=40):
    scores, timestamps = _arrays(seed, t)
    return (jscores.create_score_dataframe(scores, timestamps, CLASSES),
            tscores.create_score_dataframe(scores, timestamps, CLASSES))


def test_frame_columns_and_values_match_pandas():
    jframe, tframe = _pair(0)
    assert tframe.columns == list(jframe.columns) == [
        'onset', 'offset', *CLASSES]
    assert len(tframe) == len(jframe) == 40
    np.testing.assert_array_equal(tframe[CLASSES].to_numpy(),
                                  jframe[CLASSES].to_numpy())
    np.testing.assert_array_equal(tframe['Cat'], jframe['Cat'].to_numpy())
    ts, classes = tscores.validate_score_dataframe(tframe, CLASSES)
    jts, jclasses = jscores.validate_score_dataframe(jframe, CLASSES)
    np.testing.assert_array_equal(ts, jts)
    assert classes == jclasses == CLASSES
    with pytest.raises(AssertionError):
        tscores.validate_score_dataframe(jframe)
    with pytest.raises(AssertionError):
        tscores.validate_score_dataframe(tframe, ['Cat', 'Dog', 'Speech'])
    with pytest.raises(KeyError):
        tframe['Horse']


def test_frames_never_share_memory():
    """What indexing returns is a copy, what assignment takes is copied:
    the leaderboard's ``best[c] = candidate[c]`` leaves the candidate free
    to change, as with pandas."""
    _, tframe = _pair(1)
    before = tframe.to_numpy()
    column = tframe['Dog']
    column[:] = -1.
    sub = tframe[['Dog', 'Cat']]
    sub['Cat'] = 7.
    values = tframe[CLASSES].to_numpy()
    values[:] = 3.
    np.testing.assert_array_equal(tframe.to_numpy(), before)
    other = copy.deepcopy(tframe)
    source = np.arange(40.)
    other['Speech'] = source
    tframe['Cat'] = other['Speech']
    source[:] = 0.
    other['Speech'] = 5.
    np.testing.assert_array_equal(tframe['Cat'], np.arange(40.))
    np.testing.assert_array_equal(other['Speech'], np.full(40, 5.))


def test_frame_assignment_and_tag_masking_match_pandas():
    """``frame[classes] = array``, ``frame[classes] *= tags`` (a boolean
    row per class) and ``frame[c] = other[c]``, the calls of
    ``models/base/tuning.py``, on both frames."""
    jframe, tframe = _pair(2)
    new = np.random.RandomState(5).rand(40, len(CLASSES))
    jframe[CLASSES] = new
    tframe[CLASSES] = new
    tags = np.array([True, False, True])
    jframe[CLASSES] *= tags
    tframe[CLASSES] *= tags
    jother, tother = _pair(3)
    jframe['Speech'] = jother['Speech']
    tframe['Speech'] = tother['Speech']
    np.testing.assert_array_equal(tframe.to_numpy(), jframe.to_numpy())
    np.testing.assert_array_equal(tframe['Cat'], 0.)


@pytest.mark.parametrize('seed', [0, 1])
def test_tsv_bytes_equal_the_jax_writers(tmp_path, seed):
    jframe, tframe = _pair(seed)
    nan_frame = _pair(seed)
    jnan, tnan = nan_frame
    jnan.loc[3, 'Cat'] = np.nan
    tnan['Cat'] = np.where(np.arange(40) == 3, np.nan, tnan['Cat'])
    for j, t, name in ((jframe, tframe, 'a'), (jnan, tnan, 'nan')):
        jscores.write_sed_scores(j, tmp_path / 'jax' / f'{name}.tsv')
        tscores.write_sed_scores(t, tmp_path / 'port' / f'{name}.tsv')
        assert ((tmp_path / 'port' / f'{name}.tsv').read_bytes()
                == (tmp_path / 'jax' / f'{name}.tsv').read_bytes())
    text = (tmp_path / 'port' / 'a.tsv').read_text().splitlines()
    assert text[0] == 'onset\toffset\tDog\tCat\tSpeech'
    assert '\t1e-05\t' in text[1] and '\t0.30000000000000004\t' in text[2]


def test_each_package_reads_the_others_files(tmp_path):
    """The port reads the JAX writer's file back to the very arrays it was
    written from; pandas reads the port's file to the arrays it reads from
    its own (the same bytes). Those are within 1e-13 of the written
    values, not equal to them: pandas' default float parser keeps about
    16 significant digits of the 17 that ``repr`` writes."""
    jframe, tframe = _pair(4, t=120)
    jscores.write_sed_scores(jframe, tmp_path / 'jax' / 'clip.tsv')
    tscores.write_sed_scores(tframe, tmp_path / 'port' / 'clip.tsv')
    port_reads_jax = tscores.read_sed_scores(tmp_path / 'jax' / 'clip.tsv')
    jax_reads_port = jscores.read_sed_scores(tmp_path / 'port' / 'clip.tsv')
    jax_reads_jax = jscores.read_sed_scores(tmp_path / 'jax' / 'clip.tsv')
    assert isinstance(jax_reads_port, pd.DataFrame)
    assert port_reads_jax.columns == list(jax_reads_port.columns)
    np.testing.assert_array_equal(port_reads_jax.to_numpy(),
                                  jframe.to_numpy())
    np.testing.assert_array_equal(jax_reads_port.to_numpy(),
                                  jax_reads_jax.to_numpy())
    np.testing.assert_allclose(jax_reads_port.to_numpy(),
                               tframe.to_numpy(), rtol=1e-13, atol=1e-300)
    loader = tscores.lazy_sed_scores_loader(tmp_path / 'port')
    assert list(loader) == ['clip'] and 'clip' in loader and len(loader) == 1
    np.testing.assert_array_equal(loader['clip'].to_numpy(),
                                  tframe.to_numpy())


def test_lazy_loader_items_read_every_file(tmp_path):
    """A fresh loader's ``items()`` and ``values()`` read every file, so the
    event lists of saved scores hold every clip (the JAX loader's
    ``items()`` is ``dict``'s, empty until files are read)."""
    pairs = {f'clip{i}': _pair(20 + i) for i in range(3)}
    for clip, (_, tframe) in pairs.items():
        tscores.write_sed_scores(tframe, tmp_path / f'{clip}.tsv')
    loader = tscores.lazy_sed_scores_loader(tmp_path)
    assert [k for k, _ in loader.items()] == sorted(pairs)
    for (clip, frame), value in zip(loader.items(), loader.values()):
        np.testing.assert_array_equal(frame.to_numpy(),
                                      pairs[clip][1].to_numpy())
        assert value is frame
    events = tscores.scores_to_event_list(
        tscores.lazy_sed_scores_loader(tmp_path), .5)
    assert events == tscores.scores_to_event_list(
        {c: t for c, (_, t) in pairs.items()}, .5)
    assert dict(jscores.lazy_sed_scores_loader(tmp_path).items()) == {}


def test_event_lists_and_detection_files_match(tmp_path):
    pairs = {f'clip{i}': _pair(10 + i) for i in range(3)}
    jdict = {k: j for k, (j, _) in pairs.items()}
    tdict = {k: t for k, (_, t) in pairs.items()}
    thresholds = {'Dog': .3, 'Cat': .55, 'Speech': .8}
    for thr in (.5, thresholds):
        assert tscores.scores_to_event_list(tdict, thr) == \
            jscores.scores_to_event_list(jdict, thr)
    tscores.write_detections_for_multiple_thresholds(
        tdict, [.2, .5, .75], tmp_path / 'port')
    jscores.write_detections_for_multiple_thresholds(
        jdict, [.2, .5, .75], tmp_path / 'jax')
    names = sorted(p.name for p in (tmp_path / 'port').iterdir())
    assert names == ['0.200.tsv', '0.500.tsv', '0.750.tsv']
    for name in names:
        assert ((tmp_path / 'port' / name).read_bytes()
                == (tmp_path / 'jax' / name).read_bytes())
    tscores.write_detection(tdict, thresholds, tmp_path / 'port' / 'x.tsv')
    assert (tscores.read_ground_truth_events(tmp_path / 'port' / 'x.tsv')
            == jscores.read_ground_truth_events(
                tmp_path / 'port' / 'x.tsv'))


def test_ground_truth_readers_match_pandas(tmp_path):
    events = tmp_path / 'events.tsv'
    events.write_text(
        'filename\tonset\toffset\tevent_label\n'
        'a.wav\t0.5\t1.25\tDog\n'
        'a.wav\t2.0\t3.0\tCat\n'
        'b.wav\t\t\t\n'                      # a clip without events
        'c.wav\t0.0\t10.0\tSpeech\n'
        'c.wav\t1.0\t2.5\tDog\n'
        'd.wav\tNaN\tNaN\tNA\n')             # pandas reads all three NaN
    weak = tmp_path / 'weak.tsv'
    weak.write_text('filename\tevent_labels\n'
                    'a.wav\tDog,Cat\n'
                    'b.wav\t\n'
                    'c.wav\tSpeech\n')
    durations = tmp_path / 'durations.tsv'
    durations.write_text('filename\tduration\na.wav\t10.0\nb.wav\t9.64\n')
    got = tscores.read_ground_truth_events(events)
    assert got == jscores.read_ground_truth_events(events)
    assert got['b'] == [] and got['d'] == []
    for path in (events, weak):
        assert tscores.read_ground_truth_tags(path) == \
            jscores.read_ground_truth_tags(path)
    assert tscores.read_ground_truth_tags(weak)[0]['a'] == ['Cat', 'Dog']
    assert tscores.read_audio_durations(durations) == \
        jscores.read_audio_durations(durations) == {'a': 10., 'b': 9.64}


def test_create_score_dataframe_checks_its_shapes():
    scores, timestamps = _arrays(0)
    with pytest.raises(AssertionError):
        tscores.create_score_dataframe(scores, timestamps[:-1], CLASSES)
    with pytest.raises(AssertionError):
        tscores.create_score_dataframe(scores, timestamps, CLASSES[:2])
