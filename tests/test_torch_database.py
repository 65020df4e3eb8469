"""The port's database tools against the JAX package's on the same trees:
``database/helper.py`` (lengths and missing sets), ``resample_db``
(byte-equal files, equal dry-run job lists, a second run that skips every
file), the DESED ``create_json`` (``desed.json`` and the pseudo-labeled
variants) on a DESED-layout tree in the shape of ``tests/
test_database.py``'s, the AudioSet ``create_json`` (ontology closure,
segment CSVs, strong TSVs, missing and damaged files) on a tree in the
shape of ``tests/test_audioset.py``'s; and every CLI's ``argparse``
options."""
import argparse
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

from pb_sed_tpu.database import helper as jax_helper
from pb_sed_tpu.database import resample_db as jax_resample_db
from pb_sed_tpu.database.audioset import create_json as jax_audioset_json
from pb_sed_tpu.database.audioset import download as jax_audioset_download
from pb_sed_tpu.database.desed import create_json as jax_desed_json
from pb_sed_tpu.database.desed import download as jax_desed_download
from pb_sed_tpu_torch.data import native
from pb_sed_tpu_torch.database import helper, resample_db
from pb_sed_tpu_torch.database.audioset import create_json as audioset_json
from pb_sed_tpu_torch.database.audioset import download as audioset_download
from pb_sed_tpu_torch.database.desed import create_json as desed_json
from pb_sed_tpu_torch.database.desed import download as desed_download
from tests.test_torch_native import write_wav

SR = 16000


def _audio(seconds, rate, channels=1, seed=0):
    rng = np.random.RandomState(seed)
    return np.clip(.2 * rng.randn(int(seconds * rate), channels), -.99, .99)


def _tsv(path, header, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text('\t'.join(header) + '\n' + ''.join(
        '\t'.join(map(str, row)) + '\n' for row in rows))


@pytest.fixture(scope='module')
def desed_tree(tmp_path_factory):
    """A DESED-layout tree: strong sets (synthetic21, strong, validation,
    eval/public) with onsets, a non-target label and a clip whose row
    carries no event; a weak set with a clip without labels; an unlabeled
    set without metadata; files of other rates, widths and channels; a
    listed clip with no file; and two strong pseudo-label TSVs."""
    root = tmp_path_factory.mktemp('desed')
    audio, meta = root / 'audio', root / 'metadata'
    strong = []
    for i in range(3):
        write_wav(audio / 'train' / 'synthetic21' / f's{i}.wav',
                  _audio(1., SR, seed=i), SR)
        strong.append((f's{i}.wav', round(.1 + .123 * i, 3),
                       round(.4 + .2 * i, 3), 'Dog'))
    strong.append(('s1.wav', .05, .95, 'Cat'))
    strong.append(('s2.wav', .2, .3, 'Bark'))          # not a DESED class
    _tsv(meta / 'train' / 'synthetic21.tsv',
         ('filename', 'onset', 'offset', 'event_label'), strong)
    write_wav(audio / 'train' / 'strong' / 'y0.wav',
              _audio(.8, 44100, channels=2), 44100)
    write_wav(audio / 'train' / 'strong' / 'y1.wav', _audio(.6, 22050),
              22050, encoding='int24')
    _tsv(meta / 'train' / 'strong.tsv',
         ('filename', 'onset', 'offset', 'event_label'),
         [('y0.wav', 0., .5, 'Speech'), ('y1.wav', '', '', ''),
          ('y9.wav', .1, .2, 'Dog')])                   # y9: no file
    weak = [('w0.wav', 'Dog,Cat'), ('w1.wav', 'Speech'), ('w2.wav', '')]
    for i in range(3):
        write_wav(audio / 'train' / 'weak' / f'w{i}.wav',
                  _audio(.5, SR, seed=10 + i), SR)
    _tsv(meta / 'train' / 'weak.tsv', ('filename', 'event_labels'), weak)
    for i in range(2):
        write_wav(audio / 'train' / 'unlabel_in_domain' / f'u{i}.wav',
                  _audio(.7, SR, seed=20 + i), SR, encoding='float32')
    for purpose, name in (('validation', 'validation'), ('eval', 'public')):
        rows = []
        for i in range(2):
            write_wav(audio / purpose / name / f'{name}{i}.wav',
                      _audio(1., SR, seed=30 + i), SR)
            rows.append((f'{name}{i}.wav', .25, .75, 'Blender'))
        _tsv(meta / purpose / f'{name}.tsv',
             ('filename', 'onset', 'offset', 'event_label'), rows)
    pseudo = root / 'pseudo'
    header = ('filename', 'onset', 'offset', 'event_label')
    _tsv(pseudo / 'train_weak_pseudo_labeled.tsv', header,
         [('w0.wav', .1, .3, 'Dog'), ('w0.wav', .2, .4, 'Cat'),
          ('w2.wav', '', '', '')])
    _tsv(pseudo / 'train_unlabel_in_domain_pseudo_labeled.tsv', header,
         [('u0.wav', .0, .7, 'Frying'), ('u1.wav', .3, .35, 'Dishes')])
    return root


def test_desed_construct_json_equals_jax(desed_tree, capsys):
    got = desed_json.construct_json(desed_tree)
    printed = capsys.readouterr().out
    ref = jax_desed_json.construct_json(desed_tree)
    assert got == ref
    assert printed == capsys.readouterr().out
    datasets = got['datasets']
    assert sorted(datasets) == [
        'eval_public', 'train_strong', 'train_synthetic21',
        'train_unlabel_in_domain', 'train_weak', 'validation']
    assert datasets['train_synthetic21']['s1']['events'] == ['Dog', 'Cat']
    assert datasets['train_synthetic21']['s2']['events'] == ['Dog']
    assert datasets['train_strong']['y1']['events'] == []
    assert 'y9' not in datasets['train_strong']
    assert datasets['train_weak']['w2']['events'] == []
    assert abs(datasets['train_strong']['y0']['audio_length'] - .8) < 1e-9
    assert 'events' not in datasets['train_unlabel_in_domain']['u0']


def test_desed_create_jsons_equal_jax(desed_tree, tmp_path):
    """``desed.json`` and the pseudo-labeled variants, byte for byte; a
    variant whose directory is missing is skipped by both."""
    dirs = {'without_external': desed_tree / 'pseudo',
            'with_external': desed_tree / 'no_such_dir'}
    desed_json.create_jsons(desed_tree, tmp_path / 'port', dirs)
    jax_desed_json.create_jsons(desed_tree, tmp_path / 'jax', dirs)
    names = sorted(p.name for p in (tmp_path / 'port').iterdir())
    assert names == ['desed.json',
                     'desed_pseudo_labeled_without_external.json']
    assert names == sorted(p.name for p in (tmp_path / 'jax').iterdir())
    for name in names:
        assert (tmp_path / 'port' / name).read_bytes() \
            == (tmp_path / 'jax' / name).read_bytes(), name
    variant = json.loads(
        (tmp_path / 'port' / names[1]).read_text())['datasets']
    assert variant['train_weak']['w0']['events_start_times'] == [.1, .2]
    assert variant['train_unlabel_in_domain']['u1']['events'] == ['Dishes']


def test_desed_read_ground_truth_file_equals_jax(desed_tree):
    for path in sorted((desed_tree / 'metadata').rglob('*.tsv')) + sorted(
            (desed_tree / 'pseudo').glob('*.tsv')):
        assert desed_json.read_ground_truth_file(path) \
            == jax_desed_json.read_ground_truth_file(path), path


ONTOLOGY = [
    {'id': '/m/a', 'name': 'Animal', 'child_ids': ['/m/d', '/m/c'],
     'restrictions': []},
    {'id': '/m/d', 'name': 'Dog', 'child_ids': ['/m/b', '/m/w']},
    {'id': '/m/c', 'name': 'Cat', 'child_ids': []},
    {'id': '/m/b', 'name': 'Bark', 'child_ids': []},
    {'id': '/m/w', 'name': 'Whimper (dog)', 'child_ids': ['/m/x']},
    {'id': '/m/s', 'name': 'Speech', 'child_ids': ['/m/b'],
     'restrictions': ['abstract']},
]


@pytest.fixture(scope='module')
def audioset_tree(tmp_path_factory):
    """Segment CSVs with comment headers and quoted mids (one unknown),
    a strong TSV with an unknown mid, clips present, missing and damaged,
    and no eval strong TSV."""
    root = tmp_path_factory.mktemp('audioset')
    (root / 'ontology.json').write_text(json.dumps(ONTOLOGY))
    (root / 'balanced_train_segments.csv').write_text(
        '# Segments csv created Sun Mar  5 10:54:31 2017\n'
        '# num_ytids=3, num_segs=3, num_unique_labels=3\n'
        '# YTID, start_seconds, end_seconds, positive_labels\n'
        'abc, 30.000, 40.000, "/m/d,/m/b"\n'
        'def, 0.000, 10.000, "/m/c"\n'
        'ghi, 5.500, 15.500, "/m/s,/m/unknown"\n')
    (root / 'eval_segments.csv').write_text(
        '# eval\n'
        'jkl, 10.000, 20.000, "/m/w"\n')
    (root / 'audioset_train_strong.tsv').write_text(
        'segment_id\tstart_time_seconds\tend_time_seconds\tlabel\n'
        'abc_30000\t0.5\t1.25\t/m/b\n'
        'abc_30000\t0.1\t0.2\t/m/s\n'
        'xyz_0\t2.0\t3.0\t/m/zzz\n')
    audio = root / 'audio'
    write_wav(audio / 'balanced_train' / 'Yabc_30_40.wav',
              _audio(1., SR), SR)
    write_wav(audio / 'balanced_train' / 'Ydef_0_10.wav',
              _audio(.5, 44100, channels=2), 44100)
    # Yghi_6_16 (5.5 rounds to 6): no file; the eval clip is damaged
    (audio / 'eval').mkdir(parents=True)
    (audio / 'eval' / 'Yjkl_10_20.wav').write_bytes(b'RIFF0000WAVEjunk')
    write_wav(audio / 'train_strong' / 'Yabc.wav', _audio(.3, SR), SR)
    write_wav(audio / 'train_strong' / 'Yxyz.wav', _audio(.3, SR), SR,
              encoding='int32')
    return root


def test_audioset_create_jsons_equal_jax(audioset_tree, tmp_path):
    audioset_json.create_jsons(audioset_tree, tmp_path / 'port')
    jax_audioset_json.create_jsons(audioset_tree, tmp_path / 'jax')
    for name in ('audioset.json', 'audioset_missing_files.json'):
        assert (tmp_path / 'port' / name).read_bytes() \
            == (tmp_path / 'jax' / name).read_bytes(), name
    db = json.loads((tmp_path / 'port' / 'audioset.json').read_text())
    assert sorted(db['datasets']) == ['balanced_train', 'eval',
                                      'train_strong']
    assert db['ontology']['Bark']['ancestor_names'] == [
        'Animal', 'Dog', 'Speech']
    assert db['ontology']['Animal']['descendant_names'] == [
        'Bark', 'Cat', 'Dog', 'Whimper (dog)']
    assert db['datasets']['train_strong']['Yabc']['events'] == [
        'Speech', 'Bark']
    assert db['datasets']['eval'] == {}
    missing = json.loads(
        (tmp_path / 'port' / 'audioset_missing_files.json').read_text())
    assert missing['balanced_train']['missing'] == ['Yghi_6_16']
    assert missing['eval'] == {'missing': ['Yjkl_10_20'], 'total': 1}


@pytest.mark.parametrize('reader', ['read_segments_csv', 'read_strong_tsv'])
def test_audioset_readers_equal_jax(audioset_tree, reader):
    onto, mid_to_name = audioset_json.read_ontology(
        audioset_tree / 'ontology.json')
    assert (onto, mid_to_name) == jax_audioset_json.read_ontology(
        audioset_tree / 'ontology.json')
    for path in sorted(audioset_tree.glob('*.csv' if 'csv' in reader
                                          else '*.tsv')):
        assert getattr(audioset_json, reader)(path, mid_to_name) \
            == getattr(jax_audioset_json, reader)(path, mid_to_name)


def test_prepare_sound_dataset_equals_jax(desed_tree, audioset_tree):
    paths = sorted(desed_tree.rglob('*.wav')) + sorted(
        audioset_tree.rglob('*.wav')) + [desed_tree / 'none.wav']
    dataset = {f'c{i}': {'audio_path': str(p)} for i, p in enumerate(paths)}
    dataset['no_path'] = {}
    got = helper.prepare_sound_dataset(json.loads(json.dumps(dataset)),
                                       max_workers=3)
    ref = jax_helper.prepare_sound_dataset(json.loads(json.dumps(dataset)))
    assert got == ref
    assert len(got[1]) == 3 and {'no_path', f'c{len(paths) - 1}'} <= got[1]
    for path in paths:
        assert helper.probe_audio_length(path) \
            == jax_helper.probe_audio_length(path)


@pytest.fixture
def corpus(tmp_path):
    """A raw tree to resample: rates, widths, channels, a float file, an
    extensible one, a file no wav reader takes, and metadata."""
    src = tmp_path / 'src'
    write_wav(src / 'audio' / 'a' / 'x44.wav',
              _audio(.7, 44100, channels=2), 44100)
    write_wav(src / 'audio' / 'a' / 'x22.wav', _audio(.4, 22050), 22050,
              encoding='int24')
    write_wav(src / 'audio' / 'b' / 'x16.wav', _audio(.3, SR), SR)
    write_wav(src / 'audio' / 'b' / 'x48f.wav', _audio(.2, 48000), 48000,
              encoding='float32')
    write_wav(src / 'audio' / 'b' / 'x8u.wav', _audio(.5, 8000), 8000,
              encoding='uint8')
    write_wav(src / 'audio' / 'ext.wav', _audio(.3, 44100), 44100,
              extensible=True)
    (src / 'audio' / 'c.flac').write_bytes(b'fLaC\0\0\0')
    _tsv(src / 'metadata' / 'train' / 'weak.tsv',
         ('filename', 'event_labels'), [('x44.wav', 'Dog')])
    return src


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def _jobs(jobs, src, dst):
    return [(action, str(a.relative_to(src)), str(b.relative_to(dst)))
            for action, a, b in jobs]


def test_resample_db_equals_jax(corpus, tmp_path):
    port, jax = tmp_path / 'port', tmp_path / 'jax'
    dry = resample_db.resample_db(corpus, port, dry_run=True)
    assert _jobs(dry, corpus, port) == _jobs(
        jax_resample_db.resample_db(corpus, jax, dry_run=True), corpus, jax)
    assert not port.exists()
    jobs = resample_db.resample_db(corpus, port, num_workers=3)
    ref = jax_resample_db.resample_db(corpus, jax, num_workers=3)
    assert _jobs(jobs, corpus, port) == _jobs(ref, corpus, jax) \
        == _jobs(dry, corpus, port)
    got = _tree(port)
    assert got == _tree(jax)
    assert 'audio/c.wav' not in got            # no wav reader takes it
    assert got['metadata/train/weak.tsv'] == (
        corpus / 'metadata' / 'train' / 'weak.tsv').read_bytes()
    for name in got:
        if name.endswith('.wav'):
            assert native.wav_info(port / name)[1:] == (16000, 1), name
    # a second run finds every file done, except the one that failed
    assert _jobs(resample_db.resample_db(corpus, port), corpus, port) == [
        ('resample', 'audio/c.flac', 'audio/c.wav')]


def _options(module):
    """(flags, dest, default, type, required, action class) of every
    option of ``module.main``'s parser (its ``parse_args`` stopped)."""
    seen = {}

    class Stop(Exception):
        pass

    def parse_args(self, *args, **kwargs):
        seen['parser'] = self
        raise Stop

    with mock.patch.object(argparse.ArgumentParser, 'parse_args',
                           parse_args):
        with pytest.raises(Stop):
            module.main()
    return [(tuple(a.option_strings), a.dest, a.default, a.type, a.required,
             type(a).__name__) for a in seen['parser']._actions]


@pytest.mark.parametrize('port,ref', [
    (resample_db, jax_resample_db), (desed_json, jax_desed_json),
    (audioset_json, jax_audioset_json),
    (desed_download, jax_desed_download),
    (audioset_download, jax_audioset_download),
], ids=['resample_db', 'desed_create_json', 'audioset_create_json',
        'desed_download', 'audioset_download'])
def test_cli_options_equal_jax(port, ref):
    options = _options(port)
    assert options == _options(ref)
    assert ('--database-path', '-db') in [o[0] for o in options] or \
        ('--input-dir', '-i') in [o[0] for o in options]
    assert Path(port.__file__).name == Path(ref.__file__).name
