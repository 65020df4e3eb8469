"""Dataset preparation helper.

Capability parity with ``pb_sed/database/helper.py:7-49``
(``prepare_sound_dataset``): probe every audio file with a thread pool,
record ``audio_length`` in seconds, and drop unreadable files into a
``missing`` set.
"""
import concurrent.futures
from pathlib import Path


def probe_audio_length(path):
    """Duration in seconds of a wav file (header-only read)."""
    import wave
    try:
        with wave.open(str(path), 'rb') as fid:
            return fid.getnframes() / fid.getframerate()
    except Exception:
        try:
            from scipy.io import wavfile
            sr, data = wavfile.read(str(path))
            return data.shape[0] / sr
        except Exception:
            return None


def prepare_sound_dataset(dataset, max_workers=8):
    """Probe audio files of ``{clip_id: {'audio_path': ...}}``.

    Returns (dataset_with_audio_length, missing_ids).
    """
    missing = set()

    def probe(item):
        clip_id, example = item
        path = example.get('audio_path')
        if path is None or not Path(path).exists():
            return clip_id, None
        return clip_id, probe_audio_length(path)

    with concurrent.futures.ThreadPoolExecutor(max_workers) as pool:
        for clip_id, length in pool.map(probe, list(dataset.items())):
            if length is None:
                missing.add(clip_id)
            else:
                dataset[clip_id]['audio_length'] = length
    for clip_id in missing:
        dataset.pop(clip_id, None)
    return dataset, missing
