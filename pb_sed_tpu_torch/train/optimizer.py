"""Adam with the JAX package's surface (``pb_sed_tpu/train/optimizer.py``:
``lr``, ``gradient_clipping``, ``weight_decay``, ``betas``, ``eps``) and
its update order, the optax chain ``clip_by_global_norm`` ->
``scale_by_adam`` (bias-corrected moments, ``eps`` outside the square
root, ``eps_root`` 0) -> ``add_decayed_weights``. The trainer applies
``p - lr * u`` (``pb_sed_tpu/train/trainer.py:203-209``).

Plain tensor ops over lists of tensors (``torch._foreach_*``, a handful
of launches per step whatever the parameter count); the state is a dict
``{'count': int, 'mu': [...], 'nu': [...]}`` in parameter order.
"""
import dataclasses

import numpy as np
import torch

from pb_sed_tpu_torch.utils.config import Configurable


def global_norm(tensors):
    """sqrt of the sum of squares of all entries (a 0-dim tensor)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@dataclasses.dataclass
class Adam(Configurable):
    lr: float = 1e-3
    gradient_clipping: float = 1e10
    weight_decay: float = 0.
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8

    def init(self, params):
        return {'count': 0,
                'mu': [torch.zeros_like(p) for p in params],
                'nu': [torch.zeros_like(p) for p in params]}

    def update(self, grads, state, params):
        """Unscaled update directions for ``grads`` (mutates ``state``).
        Returns ``(updates, grad_norm)``, the norm of the raw gradients."""
        b1, b2 = self.betas
        g_norm = global_norm(grads)
        # clip_by_global_norm: unchanged below the bound, else rescaled
        coef = torch.where(g_norm < self.gradient_clipping,
                           torch.ones_like(g_norm),
                           self.gradient_clipping / g_norm)
        grads = torch._foreach_mul(grads, coef)
        mu, nu = state['mu'], state['nu']
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1. - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(
            nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1. - b2))
        state['count'] += 1
        count = np.float32(state['count'])
        c1 = float(np.float32(1.) - np.float32(b1) ** count)
        c2 = float(np.float32(1.) - np.float32(b2) ** count)
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, c2)), self.eps)
        updates = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        if self.weight_decay:
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
        return updates, g_norm
