"""The port stands alone: no module of ``pb_sed_tpu_torch`` and nothing
``chip_smoke.py`` imports names the JAX package ``pb_sed_tpu`` (an AST
scan of every import statement, lazy ones included), and every module of
the port and ``chip_smoke.py`` import, a tiny ``fuse_bn`` FBCRNN serves
and two ``Trainer`` steps run on the CPU, in a process where importing
``pb_sed_tpu``, jax, flax, optax or pandas fails; none of the eleven
kernel launch counters moves on the CPU. The entry points run on the
card unless the caller asks for the CPU. And ``chip_smoke.py`` refuses to
run without a CUDA card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

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


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
