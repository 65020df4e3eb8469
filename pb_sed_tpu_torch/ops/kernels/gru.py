"""GRU recurrence kernel (``csrc/gru.cu``) with its plain PyTorch version.

``gru_scan`` keeps the JAX package's signature and layouts
(``ops/pallas/gru.py:gru_scan``): a leading direction axis D, input
projections ``xw (D, B, T, 3H)``, recurrent weights ``w_hh (D, H, 3H)``
and bias ``b_hh (D, 3H)`` in torch gate order (r, z, n). On a CPU tensor
it runs the plain version; on a CUDA tensor it launches the kernel or
raises.
"""
import torch

from pb_sed_tpu_torch.ops.kernels import build


def _check(xw, w_hh, b_hh, h0):
    if xw.dim() != 4 or w_hh.dim() != 3 or b_hh.dim() != 2 or h0.dim() != 3:
        raise ValueError(
            f'expected xw (D, B, T, 3H), w_hh (D, H, 3H), b_hh (D, 3H), '
            f'h0 (D, B, H); got {tuple(xw.shape)}, {tuple(w_hh.shape)}, '
            f'{tuple(b_hh.shape)}, {tuple(h0.shape)}')
    d, b, _, g = xw.shape
    h = h0.shape[-1]
    if (g != 3 * h or tuple(w_hh.shape) != (d, h, 3 * h)
            or tuple(b_hh.shape) != (d, 3 * h)
            or tuple(h0.shape) != (d, b, h)):
        raise ValueError(
            f'inconsistent GRU shapes: xw {tuple(xw.shape)}, w_hh '
            f'{tuple(w_hh.shape)}, b_hh {tuple(b_hh.shape)}, h0 '
            f'{tuple(h0.shape)}')
    for name, t in (('xw', xw), ('w_hh', w_hh), ('b_hh', b_hh), ('h0', h0)):
        if not t.is_floating_point():
            raise TypeError(f'{name} must be floating point, got {t.dtype}')
        if t.device != xw.device:
            raise ValueError('all GRU operands must be on one device')


def gru_scan_plain(xw, w_hh, b_hh, h0):
    """Plain version: xw and the recurrent matmul operands rounded to
    bf16, products, gates and state in f32 (the TPU kernel's rounding
    points)."""
    xw = xw.to(torch.bfloat16).float()
    w = w_hh.to(torch.bfloat16).float()
    bias = b_hh.float()[:, None, :]
    h = h0.float()
    hdim = h.shape[-1]
    ys = []
    for t in range(xw.shape[2]):
        hw = torch.bmm(h.to(torch.bfloat16).float(), w) + bias
        x_t = xw[:, :, t]
        r = torch.sigmoid(x_t[..., :hdim] + hw[..., :hdim])
        z = torch.sigmoid(x_t[..., hdim:2 * hdim] + hw[..., hdim:2 * hdim])
        n = torch.tanh(x_t[..., 2 * hdim:] + r * hw[..., 2 * hdim:])
        h = (1. - z) * n + z * h
        ys.append(h)
    if not ys:
        return xw.new_zeros(xw.shape[:3] + (hdim,))
    return torch.stack(ys, dim=2)


def gru_scan(xw, w_hh, b_hh, h0):
    """GRU recurrence for D directions at once.

    Args:
        xw: (D, B, T, 3H) input projections incl. input bias (streamed as
            bf16).
        w_hh: (D, H, 3H) recurrent weights (rounded to bf16).
        b_hh: (D, 3H) recurrent bias (f32).
        h0: (D, B, H) initial state (f32).

    Returns: (D, B, T, H) float32 hidden states.
    """
    _check(xw, w_hh, b_hh, h0)
    if xw.device.type == 'cpu':
        return gru_scan_plain(xw, w_hh, b_hh, h0)
    build.require_cuda(xw)
    d, b, t, g = xw.shape
    hdim = g // 3
    if hdim % 32 or hdim > 512:
        raise ValueError(f'the GRU kernel takes H % 32 == 0, H <= 512; '
                         f'got H={hdim}')
    xw16 = xw.to(torch.bfloat16).contiguous()
    w16 = w_hh.to(torch.bfloat16).contiguous()
    b32 = b_hh.float().contiguous()
    h32 = h0.float().contiguous()
    y = torch.empty((d, b, t, hdim), dtype=torch.float32, device=xw.device)
    if xw16.data_ptr() % 16:
        raise ValueError('gru_scan needs a 16-byte aligned xw buffer')
    build.launch('gru_scan', 'pbsed_gru_scan', xw.device,
                 xw16.data_ptr(), w16.data_ptr(), b32.data_ptr(),
                 h32.data_ptr(), y.data_ptr(), d, b, t, hdim)
    return y
