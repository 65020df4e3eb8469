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
resumes with Adam's moments."""
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
             'experiments.core', 'experiments.weak_label_crnn.training',
             'utils.nested', 'utils.random', 'paths'):
    assert 'pb_sed_tpu_torch.' + name in names, name
from pb_sed_tpu_torch.experiments.weak_label_crnn.training import ex
cfg = ex.build_config({'timestamp': 't', 'debug': True})
assert cfg['trainer']['model']['factory'] is CRNN
assert len(build.LAUNCHES) == 11
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
                 'experiments.weak_label_crnn'):
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
