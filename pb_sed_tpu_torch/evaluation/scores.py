"""SED score frames, event-list extraction and score/detection IO, without
pandas.

Counterpart of ``pb_sed_tpu/evaluation/scores.py``, which keeps its score
tables in ``pandas.DataFrame``s; the card's machine has no pandas, so the
port keeps them in :class:`ScoreFrame`, a numpy-backed float64 table with
the part of the ``DataFrame`` API that the evaluation, tuning and inference
code uses. The functions keep the JAX module's names and results:
``create_score_dataframe(scores, timestamps, event_classes)`` (columns
``onset, offset, <class...>``), ``validate_score_dataframe``,
``scores_to_event_list`` (threshold -> per-clip event list from the
piecewise-constant score signal), ``write_sed_scores`` /
``lazy_sed_scores_loader`` TSV IO (a frame's file is byte for byte what
pandas' ``to_csv(sep='\\t', index=False)`` writes for the same float64
values: floats as ``repr``, an empty cell for NaN),
``write_detection`` / ``write_detections_for_multiple_thresholds``, and the
ground-truth TSV readers (``filename onset offset event_label``, the DESED
weak format ``filename event_labels``, ``filename duration``) through the
``csv`` module, where a cell that pandas reads as NaN (an empty cell among
them) counts as missing.
"""
import csv
from pathlib import Path

import numpy as np

# the strings pandas' ``read_csv`` reads as NaN by default
_NA_STRINGS = frozenset((
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'))


class ScoreFrame:
    """A table of float64 columns, ``['onset', 'offset', *event_classes]``
    in a score frame, one row per score frame of a clip.

    - ``frame.columns``: the column names, a list;
    - ``frame['Dog']``: one column, a new 1-D array;
    - ``frame[['Dog', 'Cat']]``: a new frame of those columns, and
      ``frame[names].to_numpy()`` its values, a new (T, len(names)) array;
    - ``frame['Dog'] = values`` and ``frame[names] = values`` (an array or
      a frame that broadcasts to the columns) copy the values in;
    - ``frame[names] *= tags`` scales the columns (``tags`` broadcast over
      the rows, as a 1-D array of one entry per column).

    Frames never share memory: what indexing returns is a copy and what an
    assignment takes is copied, as with pandas' copy-on-write frames (the
    tuning leaderboard copies single columns from frame to frame).
    """

    def __init__(self, data):
        """``data``: {column name: 1-D array}, all of one length."""
        self._columns = list(data)
        values = [np.asarray(v, dtype=np.float64) for v in data.values()]
        self._values = (np.stack(values, axis=1) if values
                        else np.zeros((0, 0)))

    @classmethod
    def _from_values(cls, columns, values):
        frame = cls.__new__(cls)
        frame._columns = list(columns)
        frame._values = values
        return frame

    @property
    def columns(self):
        return list(self._columns)

    def __len__(self):
        return self._values.shape[0]

    def _position(self, key):
        try:
            return self._columns.index(key)
        except ValueError:
            raise KeyError(key) from None

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._values[:, self._position(key)].copy()
        idx = [self._position(k) for k in key]
        return self._from_values([self._columns[i] for i in idx],
                                 self._values[:, idx])

    def __setitem__(self, key, value):
        if isinstance(value, ScoreFrame):
            value = value._values
        if isinstance(key, str):
            self._values[:, self._position(key)] = value
        else:
            self._values[:, [self._position(k) for k in key]] = value

    def __imul__(self, other):
        self._values *= np.asarray(other)
        return self

    def to_numpy(self):
        return self._values.copy()

    def __repr__(self):
        return f'ScoreFrame({len(self)} rows, columns={self._columns})'


def create_score_dataframe(scores, timestamps, event_classes):
    """(T, K) scores + (T+1,) timestamps -> score frame."""
    scores = np.asarray(scores)
    timestamps = np.asarray(timestamps, dtype=float)
    t, k = scores.shape
    assert len(timestamps) == t + 1, (len(timestamps), t)
    assert len(event_classes) == k, (len(event_classes), k)
    data = {'onset': timestamps[:-1], 'offset': timestamps[1:]}
    for i, name in enumerate(event_classes):
        data[name] = scores[:, i]
    return ScoreFrame(data)


def validate_score_dataframe(df, event_classes=None):
    """Returns (timestamps (T+1,), event_classes)."""
    assert isinstance(df, ScoreFrame), type(df)
    columns = list(df.columns)
    assert columns[:2] == ['onset', 'offset'], columns[:2]
    found_classes = columns[2:]
    if event_classes is not None:
        assert list(event_classes) == found_classes, (
            event_classes, found_classes)
    onsets = df['onset']
    offsets = df['offset']
    timestamps = np.concatenate((onsets, offsets[-1:]))
    return timestamps, found_classes


def event_list_from_score_array(scores, timestamps, event_classes,
                                thresholds):
    """Maximal runs of score > threshold -> [(onset, offset, label)].

    Args:
        scores: (T, K).
        timestamps: (T+1,).
        thresholds: scalar or per-class (K,).
    """
    scores = np.asarray(scores)
    t, k = scores.shape
    thresholds = np.broadcast_to(np.asarray(thresholds, dtype=float), (k,))
    events = []
    for ki in range(k):
        above = scores[:, ki] > thresholds[ki]
        if not above.any():
            continue
        edges = np.diff(above.astype(np.int8), prepend=0, append=0)
        onsets = np.nonzero(edges == 1)[0]
        offsets = np.nonzero(edges == -1)[0]
        for on, off in zip(onsets, offsets):
            events.append((float(timestamps[on]), float(timestamps[off]),
                           event_classes[ki]))
    return sorted(events)


def scores_to_event_list(scores, thresholds, event_classes=None):
    """Dict of score frames (or one frame) -> event list(s)."""
    if isinstance(scores, dict):
        return {
            clip_id: scores_to_event_list(df, thresholds, event_classes)
            for clip_id, df in scores.items()
        }
    timestamps, classes = validate_score_dataframe(scores, event_classes)
    arr = scores[classes].to_numpy()
    if isinstance(thresholds, dict):
        thresholds = np.array([thresholds[c] for c in classes])
    return event_list_from_score_array(arr, timestamps, classes, thresholds)


# ----------------------------------------------------------------------
# IO
# ----------------------------------------------------------------------
def _cell(x):
    return '' if x != x else repr(x)


def write_sed_scores(scores, storage_path):
    storage_path = Path(storage_path)
    storage_path.parent.mkdir(parents=True, exist_ok=True)
    with storage_path.open('w', newline='') as fid:
        csv.writer(fid, delimiter='\t', lineterminator='\n').writerow(
            scores.columns)
        fid.writelines('\t'.join(map(_cell, row)) + '\n'
                       for row in scores.to_numpy().tolist())


def _missing(cell):
    """Whether pandas' ``read_csv`` would read the cell as NaN (a cell a
    short row lacks comes as None)."""
    return cell is None or cell in _NA_STRINGS


def read_sed_scores(filepath):
    with Path(filepath).open(newline='') as fid:
        reader = csv.reader(fid, delimiter='\t')
        columns = next(reader)
        rows = [[np.nan if _missing(cell) else float(cell) for cell in row]
                for row in reader]
    values = np.array(rows, dtype=np.float64).reshape(len(rows),
                                                     len(columns))
    return ScoreFrame._from_values(columns, values)


class lazy_sed_scores_loader(dict):
    """Dict-like lazy loader over a directory of per-clip score tsvs.

    ``items()`` and ``values()`` read every file, as iterating the keys
    and indexing does (the JAX package's loader inherits ``dict``'s, which
    see only the files read so far: its event lists and detection files
    of a run that saves its scores come out empty)."""

    def __init__(self, dir_path):
        super().__init__()
        self.dir_path = Path(dir_path)
        self._files = {
            p.stem: p for p in sorted(self.dir_path.glob('*.tsv'))}

    def keys(self):
        return self._files.keys()

    def __iter__(self):
        return iter(self._files)

    def __len__(self):
        return len(self._files)

    def __contains__(self, key):
        return key in self._files

    def __getitem__(self, key):
        if not super().__contains__(key):
            super().__setitem__(key, read_sed_scores(self._files[key]))
        return super().__getitem__(key)

    def items(self):
        return [(key, self[key]) for key in self._files]

    def values(self):
        return [self[key] for key in self._files]


def write_detection(scores, threshold, filepath, event_classes=None):
    """Threshold scores -> event TSV ``filename onset offset event_label``."""
    event_lists = scores_to_event_list(scores, threshold, event_classes)
    filepath = Path(filepath)
    filepath.parent.mkdir(parents=True, exist_ok=True)
    with filepath.open('w') as fid:
        fid.write('filename\tonset\toffset\tevent_label\n')
        for clip_id in sorted(event_lists):
            for onset, offset, label in event_lists[clip_id]:
                fid.write(
                    f'{clip_id}.wav\t{onset}\t{offset}\t{label}\n')


def write_detections_for_multiple_thresholds(
        scores, thresholds, dir_path, event_classes=None, suffix='.tsv',
        threshold_decimals=3):
    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    for threshold in thresholds:
        name = f'{threshold:.{threshold_decimals}f}{suffix}'
        write_detection(scores, threshold, dir_path / name, event_classes)


def _read_rows(filepath):
    """The TSV's rows as {column: cell}, a missing cell as None."""
    with Path(filepath).open(newline='') as fid:
        return list(csv.DictReader(fid, delimiter='\t'))


def _clip_id(row):
    return str(row['filename']).rsplit('.', 1)[0]


def read_ground_truth_events(filepath):
    """TSV -> {clip_id: [(onset, offset, label)]}."""
    out = {}
    for row in _read_rows(filepath):
        clip_id = _clip_id(row)
        out.setdefault(clip_id, [])
        if not _missing(row.get('event_label')):
            out[clip_id].append((
                float(row['onset']), float(row['offset']),
                row['event_label']))
    return out


def read_ground_truth_tags(filepath):
    """TSV -> ({clip_id: [labels]}, {label: clip count}).

    Supports both the events format (``filename onset offset event_label``)
    and the DESED weak format (``filename event_labels`` with
    comma-separated labels)."""
    rows = _read_rows(filepath)
    if rows and 'event_labels' in rows[0]:
        tags = {}
        for row in rows:
            labels = row['event_labels']
            tags[_clip_id(row)] = ([] if _missing(labels)
                                   else sorted(labels.split(',')))
    else:
        events = read_ground_truth_events(filepath)
        tags = {cid: sorted({lb for *_, lb in evs})
                for cid, evs in events.items()}
    counts = {}
    for labels in tags.values():
        for lb in labels:
            counts[lb] = counts.get(lb, 0) + 1
    return tags, counts


def read_audio_durations(filepath):
    return {_clip_id(row): float(row['duration'])
            for row in _read_rows(filepath)}

