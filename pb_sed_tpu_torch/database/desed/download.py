"""DESED corpus download orchestration.

Capability parity with ``pb_sed/database/desed/download.py:53-157``. The
flow (same step order as the reference):

1. real data (weak / unlabel_in_domain / validation / eval_public):
   YouTube clips fetched via the optional ``desed`` package when
   installed; stale 2018 validation tsvs removed, ``missing_files``
   moved into the corpus.
2. AudioSet-strong labels: ``audioset_strong.tsv`` downloaded directly
   from zenodo record 6444477 and renamed ``metadata/train/strong.tsv``;
   the strong audio clips are fetched with this repo's own multiprocess
   yt-dlp downloader (``pb_sed_tpu_torch.database.audioset.download``)
   — no dependency on the desed package for this step.
3. synthetic20: soundbank via the desed package (or pre-unpacked by the
   user), jams archives directly from zenodo record 6026841, audio
   generated from jams via ``desed.generate_files_from_jams`` (scaper).
4. synthetic21: ``dcase_synth.zip`` directly from zenodo record 6026841,
   then rearranged in-place with stdlib only (delete jams/txt, move
   soundscapes to ``audio/<purpose>/synthetic21``, move the ground-truth
   tsv to ``metadata/<purpose>/synthetic21.tsv``).

Every network/optional-package step is individually skippable and
reports precisely what is missing, so a partially-provisioned corpus
can be completed incrementally.

Usage:
``python -m pb_sed_tpu_torch.database.desed.download -db /path/to/desed``
"""
import argparse
import shutil
import tarfile
import urllib.request
import zipfile
from pathlib import Path

ZENODO_AUDIOSET_STRONG = (
    'https://zenodo.org/record/6444477/files/audioset_strong.tsv')
ZENODO_JAMS20 = (
    'https://zenodo.org/record/6026841/files/'
    'DESED_synth_dcase20_train_val_jams.tar.gz',
    'https://zenodo.org/record/6026841/files/'
    'DESED_synth_dcase20_eval_jams.tar.gz',
)
ZENODO_SYNTH21 = (
    'https://zenodo.org/record/6026841/files/dcase_synth.zip')


def download_file_list(urls, dest_dir, extract=True):
    """Fetch plain files (stdlib urllib); tar/zip archives are unpacked.

    Skips files that already exist. Returns the downloaded paths.
    """
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    out = []
    for url in urls:
        name = url.rsplit('/', 1)[-1]
        target = dest_dir / name
        if not target.exists():
            print(f'Downloading {url} -> {target}')
            with urllib.request.urlopen(url) as resp, \
                    target.open('wb') as fid:
                shutil.copyfileobj(resp, fid)
        if extract and name.endswith(('.tar.gz', '.tgz')):
            with tarfile.open(target) as tar:
                tar.extractall(dest_dir)
        elif extract and name.endswith('.zip'):
            with zipfile.ZipFile(target) as zf:
                zf.extractall(dest_dir)
        out.append(target)
    return out


def download_real(database_path, n_jobs=8, chunk_size=10):
    """Real DESED audio via the desed package (YouTube sources)."""
    try:
        import desed
    except ImportError:
        print('real data SKIPPED: the `desed` package is not installed '
              '(pip install desed). The real subsets are YouTube clips '
              'and cannot be fetched from a plain archive.')
        return False
    database_path = Path(database_path)
    desed.download.download_real(
        str(database_path), n_jobs=n_jobs, chunk_size=chunk_size,
        eval=not (database_path / 'audio' / 'eval' / 'public').exists(),
    )
    # stale DCASE-2018 lists shipped inside the archive
    for name in ('test_dcase2018.tsv', 'eval_dcase2018.tsv',
                 '._test_dcase2018.tsv', '._eval_dcase2018.tsv'):
        path = database_path / 'metadata' / 'validation' / name
        if path.exists():
            path.unlink()
    missing = Path('missing_files').absolute()
    if missing.exists():
        shutil.move(str(missing), str(database_path / 'missing_files'))
    return True


def download_audioset_strong(database_path, n_jobs=8):
    """strong.tsv labels (zenodo) + audio clips (own yt-dlp pipeline)."""
    database_path = Path(database_path)
    train_meta = database_path / 'metadata' / 'train'
    strong_tsv = train_meta / 'strong.tsv'
    if not strong_tsv.exists():
        try:
            download_file_list([ZENODO_AUDIOSET_STRONG], train_meta,
                               extract=False)
        except Exception as exc:  # noqa: BLE001 — offline environments
            print(f'audioset_strong.tsv SKIPPED: {exc!r}')
            return False
        (train_meta / 'audioset_strong.tsv').rename(strong_tsv)
    clips_dir = database_path / 'audio' / 'train' / 'strong'
    missing_tsv = (database_path / 'missing_files'
                   / 'missing_files_strong.tsv')
    try:
        from pb_sed_tpu_torch.database.audioset.download import (
            download_clips_from_tsv)
        download_clips_from_tsv(
            strong_tsv, clips_dir, num_workers=n_jobs,
            missing_files_tsv=missing_tsv)
    except Exception as exc:  # noqa: BLE001
        print(f'strong audio clips SKIPPED: {exc!r}')
        return False
    return True


def download_synthetic20(database_path):
    database_path = Path(database_path)
    synthetic = database_path / 'synthetic'
    soundbank = synthetic / 'soundbank20'
    jams = synthetic / 'jams20'
    try:
        import desed
        from desed.download import split_desed_soundbank_train_val
    except ImportError:
        print('synthetic20 SKIPPED: needs the `desed` package (scaper) '
              'to synthesize audio from jams.')
        return False
    for purpose in ('train', 'validation', 'eval'):
        if not soundbank.exists():
            desed.download.download_desed_soundbank(
                str(soundbank), sins_bg=True, tut_bg=True)
        elif not (soundbank / 'audio' / 'validation').exists():
            split_desed_soundbank_train_val(str(soundbank))
        if not jams.exists():
            download_file_list(ZENODO_JAMS20, jams)
        source = (jams / 'audio' / purpose / f'synthetic20_{purpose}'
                  / 'soundscapes')
        jams_files = [str(f) for f in source.glob('*.jams')]
        desed.generate_files_from_jams(
            jams_files,
            fg_path=(soundbank / 'audio' / purpose / 'soundbank'
                     / 'foreground'),
            bg_path=(soundbank / 'audio' / purpose / 'soundbank'
                     / 'background'),
            out_folder=database_path / 'audio' / purpose / 'synthetic20',
            out_folder_jams=None,
            save_isolated_events=False,
            overwrite_exist_audio=False,
        )
        desed.generate_tsv_from_jams(
            jams_files,
            str(database_path / 'metadata' / purpose / 'synthetic20.tsv'))
    return True


def rearrange_synthetic21(database_path,
                          archive_root=None):
    """stdlib-only rearrangement of the unpacked dcase_synth archive
    (reference ``download.py:137-157``): per purpose, delete the jams /
    txt clutter, move the soundscapes into ``audio/<purpose>/
    synthetic21`` and the ground truth into
    ``metadata/<purpose>/synthetic21.tsv``."""
    database_path = Path(database_path)
    if archive_root is None:
        archive_root = database_path / 'synthetic' / 'dcase_synth'
    archive_root = Path(archive_root)
    done = []
    for purpose in ('train', 'validation'):
        audio_target = database_path / 'audio' / purpose / 'synthetic21'
        if audio_target.exists():
            done.append(purpose)
            continue
        source = (archive_root / 'audio' / purpose
                  / f'synthetic21_{purpose}' / 'soundscapes')
        if not source.exists():
            continue
        for pattern in ('*.jams', '*.txt'):
            for file in source.glob(pattern):
                file.unlink()
        audio_target.parent.mkdir(parents=True, exist_ok=True)
        source.rename(audio_target)
        ground_truth = (archive_root / 'metadata' / purpose
                        / f'synthetic21_{purpose}' / 'soundscapes.tsv')
        if ground_truth.exists():
            target_tsv = (database_path / 'metadata' / purpose
                          / 'synthetic21.tsv')
            target_tsv.parent.mkdir(parents=True, exist_ok=True)
            ground_truth.rename(target_tsv)
        done.append(purpose)
    return done


def download_synthetic21(database_path):
    database_path = Path(database_path)
    synthetic = database_path / 'synthetic'
    archive_root = synthetic / 'dcase_synth'
    if not archive_root.exists():
        try:
            download_file_list([ZENODO_SYNTH21], synthetic)
        except Exception as exc:  # noqa: BLE001
            print(f'synthetic21 SKIPPED: {exc!r}')
            return False
    return bool(rearrange_synthetic21(database_path, archive_root))


def download(database_path, n_jobs=8, chunk_size=10):
    """Full corpus provisioning; each stage skippable (see module doc)."""
    database_path = Path(database_path)
    database_path.mkdir(parents=True, exist_ok=True)
    results = {
        'real': download_real(database_path, n_jobs, chunk_size),
        'audioset_strong': download_audioset_strong(
            database_path, n_jobs),
        'synthetic20': download_synthetic20(database_path),
        'synthetic21': download_synthetic21(database_path),
    }
    print('DESED provisioning:', results)
    incomplete = [k for k, ok in results.items() if not ok]
    if incomplete:
        print(f'Incomplete stages {incomplete}; re-run after installing '
              f'the missing prerequisites or provisioning the archives '
              f'manually, then run '
              f'pb_sed_tpu_torch.database.desed.create_json')
    return results


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--database-path', '-db', required=True)
    parser.add_argument('--n-jobs', '-j', type=int, default=8)
    parser.add_argument('--chunk-size', '-c', type=int, default=10)
    args = parser.parse_args()
    download(args.database_path, args.n_jobs, args.chunk_size)


if __name__ == '__main__':
    main()
