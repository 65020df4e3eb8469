"""The port runs where there is no JAX: every module of
``pb_sed_tpu_torch`` imports, and the tiny serving slice and two
``Trainer`` steps run on the CPU, in a process where importing jax,
flax, optax or pandas fails; none of the eight kernel launch counters
moves on the CPU. And ``chip_smoke.py`` refuses to run without a CUDA
card."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import sys
for name in ('jax', 'flax', 'optax', 'pandas'):
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
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import base
from pb_sed_tpu_torch.models.weak_label import CRNN
from pb_sed_tpu_torch.ops.kernels import build
model = CRNN.from_config(CRNN.get_config({
    'feature_extractor': {'stft_size': 512, 'stft_shift': 160,
                          'stft_window_length': 480,
                          'number_of_filters': 16},
    'cnn': {'cnn_2d': {'out_channels': [16, 16], 'pool_size': [1, [2, 1]],
                       'pre_activation': True, 'use_pallas': True},
            'cnn_1d': {'out_channels': [32], 'kernel_size': 3}},
    'rnn_fwd': {'rnn': {'hidden_size': 32, 'num_layers': 2},
                'output_net': {'out_channels': [32, 10],
                               'kernel_size': 1}},
}))
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
assert len(build.LAUNCHES) == 8
assert all(v == 0 for v in build.LAUNCHES.values())
assert not any(sys.modules.get(n) for n in ('jax', 'flax', 'optax', 'pandas'))
print('ISOLATED_OK', len(names))
'''


def test_port_imports_and_serves_without_jax():
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert 'ISOLATED_OK' in out.stdout


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
