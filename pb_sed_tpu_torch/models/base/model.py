"""SoundEventModel base: an ``nn.Module`` wrapper with the JAX package's
model API (``pb_sed_tpu/models/base/model.py``).

The wrapper owns the module, the device it runs on and the label
metadata. The device is the CUDA card unless the caller asks for another
(``from_config(..., device='cpu')``, ``from_storage_dir(...,
device='cpu')``, ``to('cpu')``); without a card and without that request
the model raises (:func:`default_device`) instead of falling back to the
CPU. A wrapper built directly from its class is placed at first use, the
same way. Inference methods put the module in eval mode and run under
``torch.inference_mode()`` with the batch moved to the model's device;
training (``train/trainer.py``) puts it in train mode and calls the
subclass's ``loss`` on the same device batch.
``state_dict``/``load_state_dict`` speak the JAX package's flat
dotted-key numpy dict (``params.*`` /
``batch_stats.*``, see ``bridge.py``), and checkpoints are the same
``{'model': flat}`` pickle, so a checkpoint written by JAX training serves
here and the other way round.
"""
import pickle
from pathlib import Path

import numpy as np
import torch

from pb_sed_tpu_torch.utils.config import Configurable, instantiate
from pb_sed_tpu_torch.utils.misc import load_json


def default_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means the CUDA card, and
    raises when there is none (the port's entry points run on the card
    unless the caller passes ``device='cpu'``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' to run on the CPU")
    return torch.device('cuda')


def flatten_variables(variables, prefix=''):
    """Nested variable dict -> flat dotted-key numpy dict."""
    out = {}
    for key, value in variables.items():
        full = f'{prefix}.{key}' if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten_variables(value, full))
        else:
            out[full] = np.asarray(value)
    return out


def unflatten_variables(flat):
    out = {}
    for key, value in flat.items():
        parts = key.split('.')
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def port_config(config):
    """Point the factories of a JAX package config (``pb_sed_tpu.*``) at
    their counterparts in this package (``pb_sed_tpu_torch.*``)."""
    if isinstance(config, dict):
        out = {}
        for key, value in config.items():
            if (key == 'factory' and isinstance(value, str)
                    and value.startswith('pb_sed_tpu.')):
                value = 'pb_sed_tpu_torch.' + value[len('pb_sed_tpu.'):]
            out[key] = port_config(value)
        return out
    if isinstance(config, (list, tuple)):
        return type(config)(port_config(v) for v in config)
    return config


def _to_tensor(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.from_numpy(np.ascontiguousarray(value)).to(device)


def to_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class SoundEventModel(Configurable):
    """Base wrapper: module + device + label metadata."""

    def __init__(self, *, labelwise_metrics=(), label_mapping=None,
                 test_labels=None):
        self.labelwise_metrics = labelwise_metrics
        self.label_mapping = label_mapping
        self.test_labels = test_labels
        self.module = None  # set by subclass
        self.device = None  # placed by from_config / to / first use

    def to(self, device):
        """Move the module to ``device``; inference and training run
        there."""
        self.device = torch.device(device)
        self.module.to(self.device)
        return self

    def placed_device(self):
        """The model's device; an unplaced model goes to
        :func:`default_device` (the card) first."""
        if self.device is None:
            self.to(default_device())
        return self.device

    @classmethod
    def from_config(cls, config, device=None):
        """Instantiate ``config`` on ``device`` (default: the card)."""
        return instantiate(config).to(default_device(device))

    def num_parameters(self):
        return sum(p.numel() for p in self.module.parameters())

    # -- inference API ------------------------------------------------------
    def tagging(self, batch, **params):
        raise NotImplementedError

    def boundaries_detection(self, batch, **params):
        raise NotImplementedError

    def sound_event_detection(self, batch, **params):
        raise NotImplementedError

    def dispatch(self, method, batch, **params):
        """Same values as ``getattr(self, method)(batch, **params)`` but
        as device tensors where possible, so the call returns before the
        device is done and the inference engine overlaps its host work on
        one segment with the device work on the next. Subclasses
        override; this default is the blocking method."""
        return getattr(self, method)(batch, **params)

    def to_device(self, batch):
        """The batch's array entries as tensors on the model's device
        (lists such as example ids are left out)."""
        device = self.placed_device()
        return {k: _to_tensor(v, device) for k, v in batch.items()
                if isinstance(v, (np.ndarray, torch.Tensor))}

    def _apply(self, batch, method, **kwargs):
        """``self.module.<method>(batch, **kwargs)`` in eval and inference
        mode on the model's device; the batch's array entries are moved
        there."""
        self.module.eval()
        with torch.inference_mode():
            return getattr(self.module, method)(self.to_device(batch),
                                                **kwargs)

    # -- checkpoint IO ------------------------------------------------------
    def state_dict(self):
        """The JAX package's flat dotted-key numpy dict."""
        from pb_sed_tpu_torch.bridge import export_flat
        return export_flat(self.module)

    def load_state_dict(self, flat):
        """Load a flat dotted-key dict; missing or extra keys raise."""
        from pb_sed_tpu_torch.bridge import load_flat
        load_flat(self.module, flat)

    def save_checkpoint(self, path, extra=None):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {'model': self.state_dict()}
        if extra:
            payload.update(extra)
        with path.open('wb') as fid:
            pickle.dump(payload, fid)

    def load_checkpoint(self, path):
        """Load a ``{'model': flat}`` pickle (written by this package or
        by the JAX package's training). Only load checkpoints you trust:
        unpickling runs code."""
        with Path(path).open('rb') as fid:
            payload = pickle.load(fid)
        self.load_state_dict(payload['model'])
        return payload

    @classmethod
    def from_storage_dir(
            cls, storage_dir, config_name='1/config.json',
            checkpoint_name='ckpt_best_macro_fscore_weak.pkl',
            device=None):
        """Restore a model from a training run directory (its
        ``config.json`` may name the JAX package's classes) on ``device``
        (default: the card)."""
        device = default_device(device)
        storage_dir = Path(storage_dir)
        config = load_json(storage_dir / config_name)
        model = instantiate(port_config(config['trainer']['model']))
        model.load_checkpoint(storage_dir / 'checkpoints' / checkpoint_name)
        return model.to(device)
