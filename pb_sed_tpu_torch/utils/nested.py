"""Nested-dict flatten/deflatten (capability of paderbox.utils.nested used at
``pb_sed/experiments/weak_label_crnn/training.py:16,330``)."""


def flatten(d, sep='.', prefix=''):
    """Flatten a nested dict to dotted keys.

    >>> flatten({'a': {'b': 1, 'c': {'d': 2}}, 'e': 3})
    {'a.b': 1, 'a.c.d': 2, 'e': 3}
    """
    out = {}
    for key, value in d.items():
        full = f'{prefix}{sep}{key}' if prefix else str(key)
        if isinstance(value, dict) and value:
            out.update(flatten(value, sep=sep, prefix=full))
        else:
            out[full] = value
    return out


def deflatten(d, sep='.', maxdepth=-1):
    """Inverse of :func:`flatten`.

    >>> deflatten({'a.b': 1, 'a.c.d': 2, 'e': 3})
    {'a': {'b': 1, 'c': {'d': 2}}, 'e': 3}
    >>> deflatten({'a.b.c': 1}, maxdepth=1)
    {'a': {'b.c': 1}}
    """
    out = {}
    for key, value in d.items():
        parts = key.split(sep, maxdepth) if maxdepth >= 0 else key.split(sep)
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out
