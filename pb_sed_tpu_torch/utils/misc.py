"""Small shared utilities (timestamps, json IO, to_list).

The port's own copy of ``pb_sed_tpu/utils/misc.py``: the port imports
nothing of the JAX package. Keep the two in step.
"""
import datetime
import json
from pathlib import Path

import numpy as np


def timestamp(fmt='%Y-%m-%d-%H-%M-%S'):
    """Timestamp string used for run/group directory names
    (reference convention, ``experiments/weak_label_crnn/training.py:40-43``).
    """
    dt = datetime.datetime.now()
    return dt.strftime(fmt + '-{:02d}').format(int(dt.microsecond / 10000))


def to_list(x, length=None):
    if isinstance(x, (list, tuple)):
        x = list(x)
    else:
        x = [x]
    if length is not None:
        if len(x) == 1:
            x = x * length
        assert len(x) == length, (len(x), length)
    return x


class _JsonEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, Path):
            return str(o)
        return super().default(o)


def dump_json(obj, path, indent=2, sort_keys=False):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open('w') as fid:
        json.dump(obj, fid, indent=indent, sort_keys=sort_keys,
                  cls=_JsonEncoder)


def load_json(path):
    with Path(path).open() as fid:
        return json.load(fid)
