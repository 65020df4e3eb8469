"""The port stands alone: no module of ``pb_sed_tpu_torch`` and nothing
``chip_smoke.py`` imports names the JAX package ``pb_sed_tpu`` (an AST
scan of every import statement, lazy ones included), and every module of
the port and ``chip_smoke.py`` import, a tiny ``fuse_bn`` FBCRNN serves
and two ``Trainer`` steps run on the CPU, in a process where importing
``pb_sed_tpu``, jax, flax, optax or pandas fails; none of the eleven
kernel launch counters moves on the CPU. The entry points run on the
card unless the caller asks for the CPU. ``chip_smoke.py`` refuses to
run without a CUDA card. And a run directory written by the JAX
``Trainer`` (optax state and a JAX rng key in its checkpoints) restores in
that process: the model serves the JAX model's scores, the port's trainer
resumes with Adam's moments; a strong-label run directory of the JAX
``Trainer`` serves there too. The weak and the strong training CLIs,
chained into tuning and inference, run there."""
import ast
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ('pb_sed_tpu', 'jax', 'flax', 'optax', 'pandas')

SCRIPT = r'''
import sys
for name in BLOCKED:
    sys.modules[name] = None
import importlib, pkgutil
import numpy as np
import torch
torch.set_num_threads(2)
import pb_sed_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    pb_sed_tpu_torch.__path__, 'pb_sed_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import base
from pb_sed_tpu_torch.models.weak_label import CRNN
from pb_sed_tpu_torch.ops.kernels import build
model = CRNN.from_config(CRNN.get_config({
    'feature_extractor': {'stft_size': 512, 'stft_shift': 160,
                          'stft_window_length': 480,
                          'number_of_filters': 16},
    'cnn': {'cnn_2d': {'out_channels': [16, 16], 'pool_size': [1, [2, 1]],
                       'pre_activation': True, 'use_pallas': True,
                       'fuse_bn': True},
            'cnn_1d': {'out_channels': [32], 'kernel_size': 3}},
    'rnn_fwd': {'rnn': {'hidden_size': 32, 'num_layers': 2},
                'output_net': {'out_channels': [32, 10],
                               'kernel_size': 1}},
}), device='cpu')
assert model.module.cnn.cnn_2d.fused == {1}
model.load_state_dict(bridge.random_flat(model.state_dict(), 0))
rng = np.random.RandomState(0)
data = [{'audio_data': (.3 * rng.randn(2, 8000)).astype(np.float32),
         'seq_len': np.array([50, 40], np.int32),
         'example_id': ['a', 'b']}]
tags = base.tagging(model, data)
bounds = base.boundaries_detection(model, data, stepfilt_length=4)
sed = base.sound_event_detection(
    model, data, model_kwargs={'window_length': 11}, medfilt_length=3)
assert tags['a'].shape == (1, 10) and bounds['b'].shape == (40, 10)
assert sed['a'].shape == (50, 10)
for scores in (tags, bounds, sed):
    for v in scores.values():
        assert np.isfinite(v).all()
from pb_sed_tpu_torch.train.trainer import Trainer
batch = {k: v for k, v in data[0].items() if k != 'example_id'}
batch['weak_targets'] = (rng.rand(2, 10) > .5).astype(np.float32)
batch['boundary_targets'] = (rng.rand(2, 10, 50) > .5).astype(np.float32)
trainer = Trainer(model, stop_trigger=(2, 'iteration'))
trainer.train([batch, batch])
assert trainer.iteration == 2
assert np.isfinite(float(trainer.train_step(batch)))
for name in ('data.provider', 'data.cache', 'database.desed.provider',
             'database.audioset.provider', 'evaluation.instance_based',
             'evaluation.scores', 'evaluation.parallel',
             'evaluation.intersection_based', 'models.base.tuning',
             'models.base.pseudo_label', 'train.emissions',
             'experiments.core', 'experiments.weak_label_crnn.training',
             'experiments.weak_label_crnn.tuning',
             'experiments.weak_label_crnn.inference',
             'models.strong_label.crnn',
             'experiments.strong_label_crnn.training',
             'experiments.strong_label_crnn.tuning',
             'experiments.strong_label_crnn.inference',
             'utils.nested', 'utils.random', 'paths', 'parallel.mesh',
             'parallel.launch', 'utils.trace', 'ops.filters'):
    assert 'pb_sed_tpu_torch.' + name in names, name
from pb_sed_tpu_torch.ops import filters
from pb_sed_tpu_torch.parallel import mesh
from pb_sed_tpu_torch.utils import trace
scores = torch.rand(2, 10, 50)
assert filters.medfilt_torch(scores, 3).shape == scores.shape
assert np.allclose(filters.boundariesfilt_torch(scores, 4).numpy(),
                   filters.boundariesfilt(scores.numpy(), 4), atol=1e-6)
assert mesh.get_mesh() is None and mesh.default_ensemble_mesh(4) is None
assert trace.collapse_name('void k<1>(int)') == 'k'
from pb_sed_tpu_torch.experiments.weak_label_crnn.training import ex
cfg = ex.build_config({'timestamp': 't', 'debug': True})
assert cfg['trainer']['model']['factory'] is CRNN
from pb_sed_tpu_torch.experiments.strong_label_crnn import training
from pb_sed_tpu_torch.models import strong_label
cfg = training.ex.build_config({'timestamp': 't', 'debug': True})
assert cfg['trainer']['model']['factory'] is strong_label.CRNN
assert cfg['trainer']['model']['rnn']['rnn']['bidirectional'] is True
assert len(build.LAUNCHES) == 32
assert all(v == 0 for v in build.LAUNCHES.values())
loaded = [n for n, m in sys.modules.items() if m is not None and (
    n.split('.')[0] in BLOCKED)]
assert not loaded, loaded
print('ISOLATED_OK', len(names))
'''.replace('BLOCKED', repr(BLOCKED))


def _imported_modules(path):
    """Every module an import statement of ``path`` names (at any depth,
    so imports inside functions count)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
            names += [f'{node.module}.{alias.name}' for alias in node.names]
    return names


def test_port_sources_import_nothing_of_the_jax_package():
    sources = sorted((REPO / 'pb_sed_tpu_torch').rglob('*.py'))
    sources.append(REPO / 'chip_smoke.py')
    assert len(sources) > 20
    offending = [(str(path.relative_to(REPO)), name) for path in sources
                 for name in _imported_modules(path)
                 if name.split('.')[0] in BLOCKED]
    assert not offending, offending


def test_port_imports_and_serves_without_jax():
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert 'ISOLATED_OK' in out.stdout


def test_entry_points_default_to_the_card(tmp_path):
    """``from_config`` / ``from_storage_dir`` without a device run on the
    card and, where there is none, raise with a message that names
    ``device='cpu'`` (no quiet fallback); so do the inference functions
    and the trainer on a model built without a device."""
    from pb_sed_tpu_torch.models import base
    from pb_sed_tpu_torch.models.base.model import default_device
    from pb_sed_tpu_torch.models.weak_label import CRNN
    from pb_sed_tpu_torch.train.trainer import Trainer
    from pb_sed_tpu_torch.utils.config import instantiate
    config = CRNN.get_config({
        'feature_extractor': {'stft_size': 512, 'stft_shift': 160,
                              'stft_window_length': 480,
                              'number_of_filters': 16},
        'cnn': {'cnn_2d': {'out_channels': [16]},
                'cnn_1d': {'out_channels': [16]}},
        'rnn_fwd': {'rnn': {'hidden_size': 32},
                    'output_net': {'out_channels': [10]}},
    })
    assert CRNN.from_config(config, device='cpu').device.type == 'cpu'
    unplaced = instantiate(config)
    assert unplaced.device is None
    batch = {'audio_data': torch.zeros(1, 1600).numpy(),
             'seq_len': torch.tensor([10]).numpy()}
    if torch.cuda.is_available():
        assert default_device().type == 'cuda'
        assert CRNN.from_config(config).device.type == 'cuda'
        return
    calls = [lambda: default_device(),
             lambda: CRNN.from_config(config),
             lambda: CRNN.from_storage_dir(tmp_path),
             lambda: base.tagging(unplaced, [dict(batch, example_id=['a'])]),
             lambda: Trainer(unplaced).train_step(batch)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert unplaced.device is None


def test_strong_entry_points_default_to_the_card(tmp_path):
    """The strong-label model's entry points go to the card as the weak
    one's do: ``from_config`` / ``from_storage_dir`` without a device, the
    inference functions and the trainer on a model built without one,
    and the strong training experiment's ``device`` config is None (the
    card)."""
    from pb_sed_tpu_torch.experiments.strong_label_crnn import training
    from pb_sed_tpu_torch.models import base
    from pb_sed_tpu_torch.models.base.model import default_device
    from pb_sed_tpu_torch.models.strong_label import CRNN
    from pb_sed_tpu_torch.train.trainer import Trainer
    from pb_sed_tpu_torch.utils.config import instantiate
    from tests.test_torch_strong import CONFIG
    config = CRNN.get_config(dict(CONFIG, tag_conditioning=True))
    assert CRNN.from_config(config, device='cpu').device.type == 'cpu'
    assert training.ex.build_config({'timestamp': 't'})['device'] is None
    unplaced = instantiate(config)
    assert unplaced.device is None
    batch = {'audio_data': np.zeros((1, 1600), np.float32),
             'seq_len': np.array([10], np.int32),
             'tag_condition': np.ones((1, 5), np.float32)}
    if torch.cuda.is_available():
        assert default_device().type == 'cuda'
        assert CRNN.from_config(config).device.type == 'cuda'
        return
    train = dict(batch, strong_targets=np.zeros((1, 5, 10), np.float32))
    calls = [lambda: CRNN.from_config(config),
             lambda: CRNN.from_storage_dir(
                 tmp_path,
                 checkpoint_name='ckpt_best_macro_fscore_strong.pkl'),
             lambda: base.sound_event_detection(
                 unplaced, [dict(batch, example_id=['a'])]),
             lambda: Trainer(unplaced).train_step(train)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert unplaced.device is None


def test_package_data_ships_every_kernel_source():
    """An installed port builds its kernels from the packaged ``csrc/``:
    every file there (headers included) must match a package-data glob
    of ``pyproject.toml``."""
    import fnmatch
    import tomllib
    with open(REPO / 'pyproject.toml', 'rb') as fid:
        data = tomllib.load(fid)['tool']['setuptools']['package-data']
    globs = data['pb_sed_tpu_torch']
    package = REPO / 'pb_sed_tpu_torch'
    sources = [str(p.relative_to(package))
               for p in sorted((package / 'csrc').iterdir()) if p.is_file()]
    assert any(s.endswith('.cuh') for s in sources)
    missing = [s for s in sources
               if not any(fnmatch.fnmatch(s, g) for g in globs)]
    assert not missing, missing


def test_every_subpackage_of_the_port_is_packaged():
    """``pyproject.toml``'s package discovery finds every directory of the
    port that holds modules (each has an ``__init__.py``), the data,
    database, evaluation and experiment subpackages among them."""
    import tomllib
    from setuptools import find_packages
    with open(REPO / 'pyproject.toml', 'rb') as fid:
        find = tomllib.load(fid)['tool']['setuptools']['packages']['find']
    found = set(find_packages(str(REPO), include=find['include']))
    holding = {'.'.join(p.parent.relative_to(REPO).parts)
               for p in (REPO / 'pb_sed_tpu_torch').rglob('*.py')}
    assert holding <= found, sorted(holding - found)
    for name in ('data', 'database.desed', 'database.audioset', 'evaluation',
                 'experiments.weak_label_crnn', 'models.strong_label',
                 'experiments.strong_label_crnn'):
        assert f'pb_sed_tpu_torch.{name}' in found, name


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


# Runs where the JAX package, jax, flax, optax and pandas cannot be
# imported: argv[1] is a run directory of the JAX ``Trainer`` with
# ``expected.npz`` (a batch, the JAX model's tags for it, Adam's moments by
# flat key) beside it.
CHECKPOINT_SCRIPT = r'''
import sys
for name in BLOCKED:
    sys.modules[name] = None
import contextlib, io
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(2)
from pb_sed_tpu_torch.bridge import param_keys
from pb_sed_tpu_torch.models.weak_label import CRNN
from pb_sed_tpu_torch.train.optimizer import Adam
from pb_sed_tpu_torch.train.trainer import Trainer
storage = Path(sys.argv[1])
expected = np.load(storage / 'expected.npz')
model = CRNN.from_storage_dir(storage, device='cpu')
batch = {k: expected[k] for k in ('audio_data', 'seq_len')}
tags = model.tagging(batch)[0]
ref = expected['tags']
assert tags.shape == ref.shape, (tags.shape, ref.shape)
# the bound of test_jax_checkpoint_serves_in_port (bf16 paths that round
# at different points)
assert np.abs(tags - ref).max() <= 1e-4 + 3e-2 * np.abs(ref).max()
trainer = Trainer(model, optimizer=Adam(lr=1e-3), storage_dir=storage,
                  checkpoint_trigger=(1000, 'iteration'))
log = io.StringIO()
with contextlib.redirect_stdout(log):
    assert trainer.load_latest_checkpoint()
assert 'JAX key' in log.getvalue(), log.getvalue()
assert 'Resumed from iteration 3' in log.getvalue()
assert trainer.iteration == 3 and trainer.opt_state['count'] == 3
names = param_keys(model.module)
assert len(names) > 20
for key in ('mu', 'nu'):
    for name, moment in zip(names, trainer.opt_state[key]):
        np.testing.assert_array_equal(moment.numpy(),
                                      expected[f'{key}/{name}'])
assert all(float(nu.abs().max()) > 0 for nu in trainer.opt_state['nu'])
train_batch = {k: expected[k] for k in (
    'audio_data', 'seq_len', 'weak_targets', 'boundary_targets')}
assert np.isfinite(float(trainer.train_step(train_batch)))
assert trainer.iteration == 4 and trainer.opt_state['count'] == 4
loaded = [n for n, m in sys.modules.items() if m is not None and (
    n.split('.')[0] in BLOCKED)]
assert not loaded, loaded
print('CHECKPOINT_OK')
'''.replace('BLOCKED', repr(BLOCKED))


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """A run directory as the JAX package's training leaves it: the tiny
    FBCRNN of ``tests/test_torch_fbcrnn.py`` after 3 ``Trainer`` steps on
    the CPU (``ckpt_3.pkl``, ``ckpt_latest.pkl`` and a best-metric copy,
    each with the optax state and the rng key), its ``config.json``, and
    ``expected.npz``: a batch, the trained JAX model's tags for it, and
    Adam's moments by flat parameter key."""
    import jax
    from pb_sed_tpu.models import weak_label as jweak
    from pb_sed_tpu.models.base.model import flatten_variables
    from pb_sed_tpu.train.optimizer import Adam as JaxAdam
    from pb_sed_tpu.train.trainer import Trainer as JaxTrainer
    from pb_sed_tpu.utils.config import config_to_json
    from pb_sed_tpu.utils.misc import dump_json
    from pb_sed_tpu_torch import bridge
    from tests.test_torch_train import _config, _train_batch
    storage = tmp_path_factory.mktemp('jax_run')
    model = jweak.CRNN.from_config(jweak.CRNN.get_config(_config()))
    model.variables = jax.jit(lambda b: model.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False))(
            _train_batch(0))
    model.load_state_dict(bridge.random_flat(model.state_dict(), 7))
    trainer = JaxTrainer(model, optimizer=JaxAdam(lr=1e-3),
                         storage_dir=storage, use_mesh=False,
                         stop_trigger=(3, 'iteration'))
    trainer.train([_train_batch(seed) for seed in (1, 2, 3)])
    trainer.save_checkpoint(name='ckpt_best_macro_fscore_weak.pkl')
    dump_json({'trainer': {'model': config_to_json(
        jweak.CRNN.get_config(_config()))}}, storage / '1' / 'config.json')
    adam = [state for state in trainer.opt_state
            if type(state).__name__ == 'ScaleByAdamState']
    assert len(adam) == 1 and int(adam[0].count) == 3
    batch = _train_batch(4)
    serve = {k: batch[k] for k in ('audio_data', 'seq_len')}
    expected = dict(batch, tags=np.asarray(model.tagging(serve)[0]))
    for key in ('mu', 'nu'):
        moments = flatten_variables({'params': getattr(adam[0], key)})
        expected.update({f'{key}/{name}': np.asarray(value)
                         for name, value in moments.items()})
    np.savez(storage / 'expected.npz', **expected)
    return storage


def test_jax_trainer_checkpoint_serves_and_resumes_without_optax(jax_run):
    """``CRNN.from_storage_dir`` on the JAX trainer's run directory, where
    optax cannot be imported, serves a batch with the JAX model's scores;
    ``Trainer.load_latest_checkpoint`` restores the iteration and Adam's
    moments bit for bit, says that the JAX rng key cannot seed a
    ``torch.Generator``, and the next step trains."""
    with (jax_run / 'checkpoints' / 'ckpt_latest.pkl').open('rb') as fid:
        payload = pickle.load(fid)  # optax importable here
    assert type(payload['optimizer'][1]).__module__.startswith('optax')
    assert np.asarray(payload['rng']).dtype == np.uint32
    out = subprocess.run([sys.executable, '-c', CHECKPOINT_SCRIPT,
                          str(jax_run)], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert 'CHECKPOINT_OK' in out.stdout


def test_restricted_unpickler_keeps_fields_and_runs_no_code(jax_run,
                                                            tmp_path):
    """``load_payload`` on the JAX trainer's checkpoint in this process
    (optax importable) still imports no class: the optax states come back
    as stand-ins with their positional fields; an object whose pickle
    names a callable to run comes back as a stand-in too, uncalled; and
    numpy arrays, scalars and plain containers come back as they were."""
    from pb_sed_tpu_torch.utils.checkpoint import (Standin, adam_moments,
                                                   load_payload)
    payload = load_payload(jax_run / 'checkpoints' / 'ckpt_latest.pkl')
    assert isinstance(payload['optimizer'], tuple)
    adam = [s for s in payload['optimizer']
            if s.pickled_class.endswith('.ScaleByAdamState')]
    assert all(isinstance(s, Standin) for s in payload['optimizer'])
    assert len(adam) == 1 and len(adam[0].args) == 3
    count, mu, nu = adam_moments(payload['optimizer'])
    assert count == 3 and sorted(mu) == sorted(nu)
    assert sorted(mu) == sorted(k for k in payload['model']
                                if k.startswith('params.'))
    for key, value in mu.items():
        assert value.shape == payload['model'][key].shape

    class Evil:
        def __reduce__(self):
            return os.putenv, ('PBSED_UNPICKLED', '1')

    import collections
    import dataclasses
    Point = collections.namedtuple('Point', 'x y')
    Point.__module__, Point.__qualname__ = __name__, 'Point'
    globals()['Point'] = Point

    @dataclasses.dataclass
    class Box:
        width: int = 3
    Box.__module__, Box.__qualname__ = __name__, 'Box'
    globals()['Box'] = Box
    path = tmp_path / 'evil.pkl'
    with path.open('wb') as fid:
        pickle.dump({'evil': Evil(), 'point': Point(1, np.arange(3)),
                     'box': Box(5), 'array': np.eye(2, dtype=np.float16),
                     'scalar': np.float32(2.5), 'set': {1, 2}}, fid)
    loaded = load_payload(path)
    assert isinstance(loaded['evil'], Standin)
    assert loaded['evil'].args == ('PBSED_UNPICKLED', '1')
    assert loaded['point'].args[0] == 1
    np.testing.assert_array_equal(loaded['point'].args[1], np.arange(3))
    assert loaded['box'].width == 5
    assert loaded['array'].dtype == np.float16
    assert loaded['scalar'] == np.float32(2.5) and loaded['set'] == {1, 2}


@pytest.mark.parametrize('optimizer', [('sgd', {'lr': 1.}), 'momentum', 3])
def test_unknown_optimizer_state_raises_naming_the_cause(jax_run, tmp_path,
                                                         optimizer):
    """A checkpoint whose optimizer entry holds no Adam moments (neither
    the port's dict nor an optax ``ScaleByAdamState``) does not resume
    silently without them: ``load_latest_checkpoint`` raises and says
    why."""
    from pb_sed_tpu_torch.models.weak_label import CRNN
    from pb_sed_tpu_torch.train.trainer import Trainer
    with (jax_run / 'checkpoints' / 'ckpt_latest.pkl').open('rb') as fid:
        payload = pickle.load(fid)
    payload['optimizer'] = optimizer
    (tmp_path / 'checkpoints').mkdir()
    with (tmp_path / 'checkpoints' / 'ckpt_latest.pkl').open('wb') as fid:
        pickle.dump(payload, fid)
    model = CRNN.from_storage_dir(jax_run, device='cpu')
    trainer = Trainer(model, storage_dir=tmp_path)
    with pytest.raises(ValueError,
                       match='optimizer state written by the JAX trainer'):
        trainer.load_latest_checkpoint()


# Runs where the JAX package, jax, flax, optax and pandas cannot be
# imported (an import finder refuses them, as if they were not installed:
# sklearn, which the summaries use where it is there, looks pandas up in
# ``sys.modules`` and cannot take a None there): ``python -m
# pb_sed_tpu_torch.experiments.weak_label_crnn.training with <argv[1], a
# JSON list of key=value>``, which trains, tunes and runs inference; the
# tuning and inference directories go under $STORAGE_ROOT.
CHAIN_SCRIPT = r'''
import importlib.abc, sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ModuleNotFoundError(f'no module named {name!r}')


sys.meta_path.insert(0, Refuse())
for name in BLOCKED:
    try:
        __import__(name)
    except ModuleNotFoundError:
        continue
    raise AssertionError(f'{name} imported')
import json, os, runpy
from pathlib import Path
import torch
torch.set_num_threads(2)
sys.argv = ['training', 'with', *json.loads(sys.argv[1])]
runpy.run_module('pb_sed_tpu_torch.experiments.weak_label_crnn.training',
                 run_name='__main__', alter_sys=True)
root = Path(os.environ['STORAGE_ROOT']) / 'weak_label_crnn' / 'desed'
(hp_dir,) = (root / 'hyper_params').iterdir()
names = sorted(p.name for p in hp_dir.glob('*_hyper_params_*.json'))
assert names == ['boundaries_detection_hyper_params_f.json',
                 'sed_hyper_params_f.json', 'sed_hyper_params_psds1.json',
                 'sed_hyper_params_psds2.json',
                 'tagging_hyper_params_f.json'], names
runs = sorted((hp_dir / 'inference').iterdir())
assert len(runs) == 2, runs
results = sorted(p.name for run in runs for p in run.glob('sed_*.json'))
assert results == ['sed_f_results_eval_public.json',
                   'sed_psds1_results_eval_public.json',
                   'sed_psds2_results_eval_public.json'], results
loaded = [n for n, m in sys.modules.items() if m is not None and (
    n.split('.')[0] in BLOCKED)]
assert not loaded, loaded
print('CHAIN_OK')
'''.replace('BLOCKED', repr(BLOCKED))


def test_training_cli_chain_runs_without_jax_and_pandas(tmp_path):
    """``python -m pb_sed_tpu_torch.experiments.weak_label_crnn.training
    with device=cpu ...`` (the tiny configuration of
    ``tests/test_torch_cli.py``, ``validation_set_name`` at its default)
    trains, tunes with the debug grids and runs inference on
    ``eval_public`` for both scenarios, in a process where the JAX
    package, jax, flax, optax and pandas cannot be imported."""
    import json
    from tests.test_torch_cli import TS, _updates
    from tests.util_synth import build_database
    _, json_path = build_database(tmp_path / 'db', num_train=8, num_weak=6,
                                  num_validate=4)
    updates = _updates(json_path, tmp_path / 'train' / TS / TS,
                       num_iterations=3)
    del updates['validation_set_name']

    def flat(node, prefix=''):
        for key, value in node.items():
            if isinstance(value, dict):
                yield from flat(value, f'{prefix}{key}.')
            else:
                yield f'{prefix}{key}={value!r}'

    env = dict(os.environ, STORAGE_ROOT=str(tmp_path / 'exp'),
               OMP_NUM_THREADS='2')
    out = subprocess.run(
        [sys.executable, '-c', CHAIN_SCRIPT, json.dumps(list(flat(updates)))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert '##### Training #####' in out.stdout
    assert 'CHAIN_OK' in out.stdout


# Runs where the JAX package, jax, flax, optax and pandas cannot be
# imported: argv[1] is a strong-label run directory of the JAX
# ``Trainer`` with ``expected.npz`` (a tag-conditioned batch and the JAX
# model's frame scores for it) beside it.
STRONG_CHECKPOINT_SCRIPT = r'''
import sys
for name in BLOCKED:
    sys.modules[name] = None
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(2)
from pb_sed_tpu_torch.models.strong_label import CRNN
from pb_sed_tpu_torch.train.trainer import Trainer
storage = Path(sys.argv[1])
expected = np.load(storage / 'expected.npz')
model = CRNN.from_storage_dir(
    storage, checkpoint_name='ckpt_best_macro_fscore_strong.pkl',
    device='cpu')
assert model.tag_conditioning
batch = {k: expected[k] for k in ('audio_data', 'seq_len', 'tag_condition')}
scores, seq_len = model.sound_event_detection(batch)
ref = expected['scores']
assert scores.shape == ref.shape, (scores.shape, ref.shape)
np.testing.assert_array_equal(seq_len, batch['seq_len'])
assert np.abs(scores - ref).max() <= 1e-4 + 3e-2 * np.abs(ref).max()
trainer = Trainer(model, storage_dir=storage,
                  checkpoint_trigger=(1000, 'iteration'))
assert trainer.load_latest_checkpoint()
assert trainer.iteration == 2 and trainer.opt_state['count'] == 2
train_batch = dict(batch, strong_targets=expected['strong_targets'])
assert np.isfinite(float(trainer.train_step(train_batch)))
loaded = [n for n, m in sys.modules.items() if m is not None and (
    n.split('.')[0] in BLOCKED)]
assert not loaded, loaded
print('STRONG_CHECKPOINT_OK')
'''.replace('BLOCKED', repr(BLOCKED))


def test_jax_strong_run_serves_without_jax(tmp_path):
    """A run directory of the JAX ``Trainer`` for the tiny tag-conditioned
    BiCRNN of ``tests/test_torch_strong.py`` (2 steps on the CPU, its
    config naming the JAX classes, checkpoints with the optax state)
    restores through the port's ``from_storage_dir`` where the JAX
    package, jax, flax, optax and pandas cannot be imported, scores a
    batch as the JAX model does (``1e-4 + 3e-2 * max|ref|``) and resumes
    for a step."""
    import jax
    from pb_sed_tpu.models import strong_label as jstrong
    from pb_sed_tpu.train.optimizer import Adam as JaxAdam
    from pb_sed_tpu.train.trainer import Trainer as JaxTrainer
    from pb_sed_tpu.utils.config import config_to_json
    from pb_sed_tpu.utils.misc import dump_json
    from pb_sed_tpu_torch import bridge
    from tests.test_torch_strong import _arrays, _batch, _config
    config = jstrong.CRNN.get_config(_config(True))
    model = jstrong.CRNN.from_config(config)
    model.variables = jax.jit(lambda b: model.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False))(
            _arrays(_batch(0)))
    model.load_state_dict(bridge.random_flat(model.state_dict(), 7))
    trainer = JaxTrainer(model, optimizer=JaxAdam(lr=1e-3),
                         storage_dir=tmp_path, use_mesh=False,
                         stop_trigger=(2, 'iteration'))
    trainer.train([_arrays(_batch(seed)) for seed in (1, 2)])
    trainer.save_checkpoint(name='ckpt_best_macro_fscore_strong.pkl')
    dump_json({'trainer': {'model': config_to_json(config)}},
              tmp_path / '1' / 'config.json')
    batch = _arrays(_batch(4))
    serve = {k: batch[k] for k in ('audio_data', 'seq_len', 'tag_condition')}
    np.savez(tmp_path / 'expected.npz', **batch,
             scores=np.asarray(model.sound_event_detection(serve)[0]))
    out = subprocess.run([sys.executable, '-c', STRONG_CHECKPOINT_SCRIPT,
                          str(tmp_path)], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert 'STRONG_CHECKPOINT_OK' in out.stdout


# ``python -m pb_sed_tpu_torch.experiments.strong_label_crnn.training
# with <argv[1], a JSON list of key=value>`` where the JAX package, jax,
# flax, optax and pandas cannot be imported (the finder of CHAIN_SCRIPT):
# it trains, tunes and runs inference on eval_public; the tuning and
# inference directories go under $STORAGE_ROOT.
STRONG_CHAIN_SCRIPT = CHAIN_SCRIPT[:CHAIN_SCRIPT.index('runpy.run_module')] \
    + r'''
runpy.run_module('pb_sed_tpu_torch.experiments.strong_label_crnn.training',
                 run_name='__main__', alter_sys=True)
root = Path(os.environ['STORAGE_ROOT']) / 'strong_label_crnn' / 'desed'
(hp_dir,) = (root / 'hyper_params').iterdir()
names = sorted(p.name for p in hp_dir.glob('sed_hyper_params_*.json'))
assert names == ['sed_hyper_params_f.json', 'sed_hyper_params_psds1.json',
                 'sed_hyper_params_psds2.json'], names
(run,) = (hp_dir / 'inference').iterdir()
results = sorted(p.name for p in run.glob('sed_*.json'))
assert results == ['sed_f_results_eval_public.json',
                   'sed_psds1_results_eval_public.json'], results
loaded = [n for n, m in sys.modules.items() if m is not None and (
    n.split('.')[0] in BLOCKED)]
assert not loaded, loaded
print('STRONG_CHAIN_OK')
'''.replace('BLOCKED', repr(BLOCKED))


def test_strong_cli_chain_runs_without_jax_and_pandas(tmp_path):
    """``python -m pb_sed_tpu_torch.experiments.strong_label_crnn.training
    with device=cpu ...`` (the tiny configuration of
    ``tests/test_torch_strong_cli.py``, a weak ensemble of one 2-iteration
    run) trains, tunes with the debug median filter and runs inference on
    ``eval_public``, in a process where the JAX package, jax, flax, optax
    and pandas cannot be imported."""
    import json
    from tests.test_torch_cli import TS
    from tests.test_torch_strong_cli import (strong_updates,
                                             weak_hyper_params_dir)
    from tests.util_synth import build_database
    _, json_path = build_database(tmp_path / 'db', num_train=8, num_weak=6,
                                  num_validate=4)
    weak_hp_dir = weak_hyper_params_dir(tmp_path, json_path)
    updates = strong_updates(json_path, tmp_path / 'strong' / TS / TS,
                             weak_hp_dir)
    del updates['validation_set_name']

    def flat(node, prefix=''):
        for key, value in node.items():
            if isinstance(value, dict):
                yield from flat(value, f'{prefix}{key}.')
            else:
                yield f'{prefix}{key}={value!r}'

    env = dict(os.environ, STORAGE_ROOT=str(tmp_path / 'exp'),
               OMP_NUM_THREADS='2')
    out = subprocess.run(
        [sys.executable, '-c', STRONG_CHAIN_SCRIPT,
         json.dumps(list(flat(updates)))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert '##### Training #####' in out.stdout
    assert 'STRONG_CHAIN_OK' in out.stdout
