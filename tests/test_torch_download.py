"""The port's downloaders without network: the cases of
``tests/test_download.py`` on the port's modules (segment CSV parsing, the
queue-based multi-worker fetcher with per-clip failures, the DESED
downloader's soft failure, the synthetic21 rearrangement, the strong TSV's
segments and the missing-files manifest), the pure parsers against the
JAX package's, archives unpacked from a mocked fetch, and the gates on a
missing ``desed`` package and missing tools. Every test runs with name
resolution and socket connections refused, and fetches through mocks."""
import io
import shutil
import socket
import sys
import urllib.error
import urllib.request
import zipfile
from pathlib import Path
from unittest import mock

import pytest

from pb_sed_tpu.database.audioset import download as jax_audioset_download
from pb_sed_tpu.database.desed import download as jax_desed_download
from pb_sed_tpu_torch.database.audioset import download as dl
from pb_sed_tpu_torch.database.desed import download as desed_dl


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Any attempt to resolve a name or open a connection fails here,
    before it leaves the process."""
    def refuse(*args, **kwargs):
        raise OSError('network access is refused in these tests')

    for name in ('getaddrinfo', 'create_connection', 'gethostbyname'):
        monkeypatch.setattr(socket, name, refuse)
    monkeypatch.setattr(socket.socket, 'connect', refuse)
    monkeypatch.setattr(socket.socket, 'connect_ex', refuse)


@pytest.fixture
def offline(monkeypatch):
    """urllib's fetches raise as offline ones do, and are recorded;
    neither yt-dlp nor ffmpeg nor the ``desed`` package is found."""
    calls = []

    def unreachable(url, *args, **kwargs):
        calls.append(url)
        raise urllib.error.URLError('offline')

    monkeypatch.setattr(urllib.request, 'urlopen', unreachable)
    monkeypatch.setattr(urllib.request, 'urlretrieve', unreachable)
    monkeypatch.setattr(shutil, 'which', lambda tool: None)
    monkeypatch.setitem(sys.modules, 'desed', None)
    return calls


SEGMENTS_CSV = (
    '# Segments csv\n'
    '# num_ytids=2\n'
    'abc123, 10.000, 20.000, "/m/09x0r,/m/05zppz"\n'
    'def456, 0.000, 10.000, "/m/09x0r"\n'
    'g_h-7, 3.500, 13.500, "/m/05zppz"\n')
STRONG_TSV = (
    'filename\tonset\toffset\tevent_label\n'
    'Yabc123_30.000_40.000.wav\t0.1\t2.0\tDog\n'
    'Yabc123_30.000_40.000.wav\t3.0\t4.0\tCat\n'   # same clip
    'Yd_ef-4_5.000_15.000.wav\t1.0\t2.0\tDog\n'    # _ in ytid
    'badname.wav\t1.0\t2.0\tDog\n')                # no segment in it


def test_read_segments(tmp_path):
    csv_path = tmp_path / 'segments.csv'
    csv_path.write_text(SEGMENTS_CSV)
    segments = dl.read_segments(csv_path)
    assert len(segments) == 3
    clip_id, ytid, start, end = segments[0]
    assert ytid == 'abc123'
    assert (start, end) == (10., 20.)
    assert clip_id == 'Yabc123_10_20'
    assert segments == jax_audioset_download.read_segments(csv_path)


def test_download_clips_tolerates_failures(tmp_path):
    """Per-clip failures are collected, not raised."""
    segments = [(f'clip{i}', f'yt{i}', 0., 10.) for i in range(6)]

    def fake_download_clip(ytid, start, end, out_path, timeout=60,
                           **kwargs):
        ok = int(ytid[2:]) % 2 == 0
        if ok:
            Path(out_path).write_bytes(b'RIFF')
        return ok

    with mock.patch.object(dl, 'download_clip', fake_download_clip):
        failed = dl.download_clips(
            segments, tmp_path / 'audio', num_workers=3)
    assert sorted(failed) == ['clip1', 'clip3', 'clip5']
    assert sorted(p.name for p in (tmp_path / 'audio').glob('*.wav')) \
        == ['clip0.wav', 'clip2.wav', 'clip4.wav']


def test_download_clip_without_tools_fails_soft(tmp_path, offline):
    """yt-dlp missing: the subprocess raises ``OSError``, the clip fails;
    a clip already on disk is not fetched again."""
    with mock.patch.object(dl.subprocess, 'run',
                           side_effect=FileNotFoundError('yt-dlp')) as run:
        assert dl.download_clip('abc', 0., 10., tmp_path / 'a.wav') \
            is False
        (tmp_path / 'b.wav').write_bytes(b'RIFF')
        assert dl.download_clip('abc', 0., 10., tmp_path / 'b.wav') is True
    (cmd,), kwargs = run.call_args
    assert cmd[0] == 'yt-dlp' and kwargs['timeout'] == 60
    assert 'ffmpeg:-ss 0.0 -to 10.0 -ar 16000 -ac 1' in cmd


def test_desed_download_gates_on_missing_tools(tmp_path, offline, capsys):
    """Without network, tools or the ``desed`` package the downloader
    reports each stage it skipped and fails soft, as the JAX one does:
    the same stages, messages and tree."""
    results = desed_dl.download(tmp_path / 'port', n_jobs=1)
    port_out = capsys.readouterr().out
    ref = jax_desed_download.download(tmp_path / 'jax', n_jobs=1)
    jax_out = capsys.readouterr().out
    assert results == ref == {'real': False, 'audioset_strong': False,
                              'synthetic20': False, 'synthetic21': False}
    assert 'the `desed` package is not installed' in port_out
    assert 'Incomplete stages' in port_out
    assert port_out.replace('port', 'jax').replace(
        'pb_sed_tpu_torch', 'pb_sed_tpu') == jax_out
    assert sorted(str(p.relative_to(tmp_path / 'port'))
                  for p in (tmp_path / 'port').rglob('*')) == sorted(
        str(p.relative_to(tmp_path / 'jax'))
        for p in (tmp_path / 'jax').rglob('*'))
    assert len(offline) == 4 and all(
        url.startswith('https://zenodo.org/') for url in offline)


def _archive(tmp_path):
    buffer = io.BytesIO()
    with zipfile.ZipFile(buffer, 'w') as zf:
        root = 'dcase_synth/audio/train/synthetic21_train/soundscapes/'
        zf.writestr(root + 'clip0.wav', b'RIFF')
        zf.writestr(root + 'clip0.jams', '{}')
        zf.writestr('dcase_synth/metadata/train/synthetic21_train/'
                    'soundscapes.tsv', 'filename\tonset\toffset\t'
                    'event_label\n')
    return buffer.getvalue()


def test_synthetic21_from_a_fetched_archive(tmp_path, offline,
                                            monkeypatch):
    """``download_synthetic21`` unpacks the fetched zip and rearranges it;
    the fetch is a mock that serves the archive's bytes."""
    data = _archive(tmp_path)
    monkeypatch.setattr(urllib.request, 'urlopen',
                        lambda url: io.BytesIO(data))
    db = tmp_path / 'desed'
    assert desed_dl.download_synthetic21(db) is True
    assert (db / 'audio' / 'train' / 'synthetic21' / 'clip0.wav').exists()
    assert not list((db / 'audio' / 'train' / 'synthetic21').glob('*.jams'))
    assert (db / 'metadata' / 'train' / 'synthetic21.tsv').exists()
    # a second fetch list finds the archive on disk and fetches nothing
    monkeypatch.setattr(urllib.request, 'urlopen', None)
    assert desed_dl.download_file_list(
        [desed_dl.ZENODO_SYNTH21], db / 'synthetic', extract=False) == [
        db / 'synthetic' / 'dcase_synth.zip']


def test_synthetic21_rearrangement(tmp_path):
    """The unpacked dcase_synth archive rearranged into the corpus layout,
    as the JAX package does it."""
    trees = {}
    for module in (desed_dl, jax_desed_download):
        db = tmp_path / module.__name__
        archive = db / 'synthetic' / 'dcase_synth'
        for purpose in ('train', 'validation'):
            scapes = (archive / 'audio' / purpose
                      / f'synthetic21_{purpose}' / 'soundscapes')
            scapes.mkdir(parents=True)
            (scapes / 'clip0.wav').write_bytes(b'RIFF')
            (scapes / 'clip0.jams').write_text('{}')
            (scapes / 'notes.txt').write_text('x')
            meta = (archive / 'metadata' / purpose
                    / f'synthetic21_{purpose}')
            meta.mkdir(parents=True)
            (meta / 'soundscapes.tsv').write_text(
                'filename\tonset\toffset\tevent_label\n')
        done = module.rearrange_synthetic21(db, archive)
        assert done == ['train', 'validation']
        for purpose in ('train', 'validation'):
            target = db / 'audio' / purpose / 'synthetic21'
            assert (target / 'clip0.wav').exists()
            assert not list(target.glob('*.jams'))
            assert not list(target.glob('*.txt'))
            assert (db / 'metadata' / purpose / 'synthetic21.tsv').exists()
        # idempotent: a second run reports done without touching anything
        assert module.rearrange_synthetic21(db, archive) == done
        trees[module] = sorted(str(p.relative_to(db))
                               for p in db.rglob('*'))
    assert trees[desed_dl] == trees[jax_desed_download]


def test_segments_from_desed_strong_tsv(tmp_path):
    tsv = tmp_path / 'strong.tsv'
    tsv.write_text(STRONG_TSV)
    segments = dl.segments_from_desed_strong_tsv(tsv)
    assert len(segments) == 2
    assert segments[0] == ('Yabc123_30.000_40.000', 'abc123', 30., 40.)
    assert segments[1] == ('Yd_ef-4_5.000_15.000', 'd_ef-4', 5., 15.)
    assert segments == jax_audioset_download.segments_from_desed_strong_tsv(
        tsv)

    # failed clips land in the missing-files manifest
    with mock.patch.object(dl, 'download_clip', lambda *a, **k: False):
        failed = dl.download_clips_from_tsv(
            tsv, tmp_path / 'audio', num_workers=2,
            missing_files_tsv=tmp_path / 'missing' / 'strong.tsv')
    assert len(failed) == 2
    manifest = (tmp_path / 'missing' / 'strong.tsv').read_text()
    assert 'Yabc123_30.000_40.000.wav' in manifest


def test_audioset_download_gates_on_missing_tools(tmp_path, offline,
                                                  capsys):
    assert dl.download(tmp_path / 'as', num_workers=2) is False
    out = capsys.readouterr().out
    assert "Missing tools: ['yt-dlp', 'ffmpeg']" in out
    assert not (tmp_path / 'as').exists() and offline == []
    assert jax_audioset_download.download(tmp_path / 'as', 2) is False
    assert capsys.readouterr().out == out


@pytest.mark.parametrize('train_strong_only', [False, True])
def test_audioset_download_queues_every_segment(tmp_path, offline,
                                                monkeypatch, capsys,
                                                train_strong_only):
    """With the tools found: the metadata fetch fails soft (offline), the
    segment files on disk are read and each set's clips are queued to its
    audio directory (the fetcher mocked); the strong TSV's segment ids
    give 10 s clips from their millisecond offsets."""
    monkeypatch.setattr(shutil, 'which', lambda tool: f'/bin/{tool}')
    db = tmp_path / 'as'
    db.mkdir()
    (db / 'balanced_train_segments.csv').write_text(SEGMENTS_CSV)
    (db / 'eval_segments.csv').write_text(SEGMENTS_CSV.splitlines(True)[2]
                                          .replace('abc123', 'e1'))
    (db / 'audioset_train_strong.tsv').write_text(
        'segment_id\tstart_time_seconds\tend_time_seconds\tlabel\n'
        'x_y_30000\t0.5\t1.2\t/m/1\n'
        'x_y_30000\t2.0\t3.0\t/m/2\n'
        'z_0\t0.0\t1.0\t/m/1\n')
    queued = {}

    def download_clips(segments, target, num_workers=4, timeout=60):
        queued[Path(target).name] = segments
        return [segments[0][0]]

    monkeypatch.setattr(dl, 'download_clips', download_clips)
    assert dl.download(db, 2, train_strong_only) is True
    out = capsys.readouterr().out
    assert len(offline) == 3   # the segment files are on disk already
    if train_strong_only:
        assert queued == {'train_strong': [
            ('Yx_y_30000', 'x_y', 30., 40.), ('Yz_0', 'z', 0., 10.)]}
    else:
        assert sorted(queued) == ['balanced_train', 'eval']
        assert queued['balanced_train'] == dl.read_segments(
            db / 'balanced_train_segments.csv')
        assert queued['eval'] == [('Ye1_10_20', 'e1', 10., 20.)]
    assert out.count('1 clips failed') == len(queued)
