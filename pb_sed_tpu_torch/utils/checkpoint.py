"""Reading training checkpoints without the packages that wrote them.

A checkpoint of the JAX package's ``Trainer``
(``pb_sed_tpu/train/trainer.py:save_checkpoint``) is a pickle of numpy
arrays in plain containers, except its ``'optimizer'`` entry: the optax
state, whose containers are optax's classes (named tuples such as
``ScaleByAdamState(count, mu, nu)``). ``pickle.load`` imports the module
of every class it meets, so it fails where optax is not installed, which
is where this package runs. :func:`load_payload` reads such a file with
an unpickler that lets numpy and a few builtin containers through and
turns every other class into a plain stand-in that keeps its fields: no
import of optax, jax or the JAX package, and no code of the file's
choosing runs. :func:`adam_moments` finds Adam's moments in either
trainer's optimizer entry and names them by flat dotted parameter key.
"""
import pickle
from pathlib import Path

import numpy as np

# what a checkpoint's plain containers and numpy arrays need
_BUILTINS = {'dict', 'list', 'tuple', 'set', 'frozenset', 'slice', 'complex',
             'int', 'float', 'bool', 'str', 'bytes', 'bytearray', 'range'}
_COLLECTIONS = {'OrderedDict'}


class Standin:
    """An instance of a class that was not imported: ``args`` holds what
    its constructor (or ``__new__``) was given, in order (a named tuple's
    positional fields), ``__dict__`` what its state set (a dataclass's
    fields). ``pickled_class`` is the dotted name of the class."""
    pickled_class = ''

    def __new__(cls, *args, **kwargs):
        self = object.__new__(cls)
        self.args = args
        self.kwargs = kwargs
        return self

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.state = state

    def __repr__(self):
        return f'<stand-in for {self.pickled_class}>'


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, fid):
        super().__init__(fid)
        self._standins = {}

    def find_class(self, module, name):
        top = module.split('.')[0]
        if (top == 'numpy' or (module == 'builtins' and name in _BUILTINS)
                or (module == 'collections' and name in _COLLECTIONS)):
            return super().find_class(module, name)
        key = f'{module}.{name}'
        if key not in self._standins:
            self._standins[key] = type(name, (Standin,),
                                       {'pickled_class': key})
        return self._standins[key]


def load_payload(path):
    """The payload of a checkpoint file: numpy arrays and plain
    containers as they were written, every other object a
    :class:`Standin`."""
    with Path(path).open('rb') as fid:
        return _RestrictedUnpickler(fid).load()


def _children(node):
    """The (key, value) pairs below a container or stand-in."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if isinstance(node, Standin):
        fields = {k: v for k, v in vars(node).items()
                  if k not in ('args', 'kwargs')}
        return (list(enumerate(node.args)) + list(node.kwargs.items())
                + list(fields.items()))
    return []


def _flatten(tree, prefix):
    """Nested dicts of arrays -> {dotted key: array}."""
    if isinstance(tree, Standin):
        raise ValueError(f'{prefix}: {tree!r} where a parameter tree of '
                         f'plain dicts and arrays was expected')
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for key, value in tree.items():
        out.update(_flatten(value, f'{prefix}.{key}'))
    return out


def _find_adam_state(node):
    if (isinstance(node, Standin)
            and node.pickled_class.endswith('.ScaleByAdamState')):
        return node
    for _, child in _children(node):
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def adam_moments(optimizer):
    """Adam's state from a checkpoint's ``'optimizer'`` entry as
    ``(count, mu, nu)`` with ``mu`` and ``nu`` dicts from flat parameter
    key (``params.<module path>.<name>``) to array. Takes this package's
    entry (``{'count', 'mu', 'nu'}`` by flat key) and the JAX trainer's
    (the optax chain's state, read through :func:`load_payload`: its
    ``ScaleByAdamState(count, mu, nu)`` holds the moments as trees shaped
    like the parameters). Raises a ``ValueError`` that names the cause for
    anything else."""
    if isinstance(optimizer, dict) and {'count', 'mu', 'nu'} <= set(optimizer):
        return (int(optimizer['count']), dict(optimizer['mu']),
                dict(optimizer['nu']))
    state = _find_adam_state(optimizer)
    if state is None or len(state.args) != 3:
        raise ValueError(
            'the optimizer state of this checkpoint is neither this '
            "package's nor an optimizer state written by the JAX trainer "
            'with a ScaleByAdamState(count, mu, nu) in it: '
            f'{type(optimizer).__name__}')
    count, mu, nu = state.args
    return (int(np.asarray(count)), _flatten(mu, 'params'),
            _flatten(nu, 'params'))
