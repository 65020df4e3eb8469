"""GRU recurrence kernels, forward (``csrc/gru.cu``) and backward
(``csrc/gru_bwd.cu``, and the fused ``csrc/gru_bwd_fused.cu``), with
their plain PyTorch versions and the autograd Function ``GruScan`` that
ties them together.

``gru_scan`` keeps the JAX package's signature and layouts
(``ops/pallas/gru.py:gru_scan``): a leading direction axis D, input
projections ``xw (D, B, T, 3H)``, recurrent weights ``w_hh (D, H, 3H)``
and bias ``b_hh (D, 3H)`` in torch gate order (r, z, n). On a CPU tensor
a wrapper runs the plain version; on a CUDA tensor it launches the kernel
or raises. The backward is the JAX package's split variant
(``_gru_scan_pallas_bwd(split=True)``): the kernel sweeps t in reverse
and emits bf16 dxw, bf16 r and f32 dh0; dw_hh and db_hh are one
contraction over the (B*T) axis afterwards. ``gru_scan_bwd(...,
split=False)`` is the fused variant (``_gru_scan_pallas_bwd(split=False)``),
which accumulates dw_hh and db_hh inside the sweep; as in the JAX
package, no training path selects it.
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


def _check_bwd(xw, w_hh, b_hh, h0, y, g):
    _check(xw, w_hh, b_hh, h0)
    want = tuple(h0.shape[:2]) + (xw.shape[2], h0.shape[-1])
    for name, t in (('y', y), ('g', g)):
        if tuple(t.shape) != want:
            raise ValueError(f'{name} shape {tuple(t.shape)} != {want}')
        if t.device != xw.device:
            raise ValueError('all GRU operands must be on one device')


def _h_prev(h0, y):
    """(D, B, T, H) bf16 state before each step: concat(h0, y[:-1])."""
    t = y.shape[2]
    return torch.cat([h0[:, :, None].float(), y[:, :, :max(t - 1, 0)]],
                     dim=2)[:, :, :t].to(torch.bfloat16)


def _weight_grads(h_prev, dxw, r):
    """dw_hh (D, H, 3H) and db_hh (D, 3H) in f32 from bf16 operands:
    dgates = [dxw_r, dxw_z, dxw_n * r] (a bf16 product of the two bf16
    outputs) contracted with bf16 h_prev over (B, T)
    (``pb_sed_tpu/ops/pallas/gru.py:546-552``)."""
    hdim = r.shape[-1]
    dgates = torch.cat([dxw[..., :2 * hdim], dxw[..., 2 * hdim:] * r],
                       dim=-1).float()
    dw_hh = torch.einsum('dbth,dbtg->dhg', h_prev.float(), dgates)
    return dw_hh, dgates.sum((1, 2))


def gru_scan_bwd_plain(xw, w_hh, b_hh, h0, y, g, split=True):
    """Plain backward: a reverse Python loop with the kernels' rounding
    points (bf16 h_prev in the recompute and in dz, dxw and r rounded to
    bf16, dh in f32, dh's matmul on bf16 dgates). ``split`` picks how
    dw_hh and db_hh are formed: from bf16 dxw and r afterwards (the split
    kernel), or, with ``split=False`` (the fused kernel,
    ``pb_sed_tpu/ops/pallas/gru.py:335-341``), dw_hh from the bf16
    dgates of each step and db_hh from the f32 ones."""
    xw = xw.to(torch.bfloat16).float()
    w = w_hh.to(torch.bfloat16).float()
    bias = b_hh.float()[:, None, :]
    h_prev = _h_prev(h0, y)
    hp = h_prev.float()
    g = g.float()
    d, b, t, three_h = xw.shape
    hdim = three_h // 3
    dh = torch.zeros((d, b, hdim), dtype=torch.float32, device=xw.device)
    dxw = torch.empty((d, b, t, three_h), dtype=torch.bfloat16,
                      device=xw.device)
    r_all = torch.empty((d, b, t, hdim), dtype=torch.bfloat16,
                        device=xw.device)
    if not split:
        dg_all = torch.empty_like(dxw)
        db_hh = torch.zeros((d, three_h), dtype=torch.float32,
                            device=xw.device)
    w_t = w.transpose(1, 2)
    for s in reversed(range(t)):
        h_p = hp[:, :, s]
        hw = torch.bmm(h_p, w) + bias
        x_t = xw[:, :, s]
        hn = hw[..., 2 * hdim:]
        r = torch.sigmoid(x_t[..., :hdim] + hw[..., :hdim])
        z = torch.sigmoid(x_t[..., hdim:2 * hdim] + hw[..., hdim:2 * hdim])
        n = torch.tanh(x_t[..., 2 * hdim:] + r * hn)
        dht = g[:, :, s] + dh
        dz = dht * (h_p - n) * z * (1. - z)
        dpn = dht * (1. - z) * (1. - n * n)
        dpr = dpn * hn * r * (1. - r)
        dxw[:, :, s] = torch.cat([dpr, dz, dpn], dim=-1).to(torch.bfloat16)
        r_all[:, :, s] = r.to(torch.bfloat16)
        dgates = torch.cat([dpr, dz, dpn * r], dim=-1)
        if not split:
            db_hh += dgates.sum(1)
        dgates = dgates.to(torch.bfloat16)
        if not split:
            dg_all[:, :, s] = dgates
        dh = dht * z + torch.bmm(dgates.float(), w_t)
    if split:
        dw_hh, db_hh = _weight_grads(h_prev, dxw, r_all)
    else:
        dw_hh = torch.einsum('dbth,dbtg->dhg', hp, dg_all.float())
    return dxw, dw_hh, db_hh, dh


def gru_scan_bwd(xw, w_hh, b_hh, h0, y, g, split=True):
    """Backward of :func:`gru_scan` for cotangent ``g`` of its output
    ``y``: the split kernel (default), or with ``split=False`` the fused
    one (:func:`gru_scan_bwd_plain` names the rounding difference).

    Returns: dxw (D, B, T, 3H) bfloat16, dw_hh (D, H, 3H), db_hh (D, 3H)
    and dh0 (D, B, H), all float32 but dxw.
    """
    _check_bwd(xw, w_hh, b_hh, h0, y, g)
    if xw.device.type == 'cpu':
        return gru_scan_bwd_plain(xw, w_hh, b_hh, h0, y, g, split)
    build.require_cuda(xw, w_hh, b_hh, h0, y, g)
    d, b, t, g3 = xw.shape
    hdim = g3 // 3
    if hdim % 32 or hdim > 512:
        raise ValueError(f'the GRU backward kernel takes H % 32 == 0, '
                         f'H <= 512; got H={hdim}')
    xw16 = xw.to(torch.bfloat16).contiguous()
    h_prev = _h_prev(h0, y).contiguous()
    w16 = w_hh.to(torch.bfloat16).contiguous()
    b32 = b_hh.float().contiguous()
    g32 = g.float().contiguous()
    dxw = torch.empty_like(xw16)
    dh0 = torch.empty((d, b, hdim), dtype=torch.float32, device=xw.device)
    if h_prev.data_ptr() % 16:
        raise ValueError('gru_scan_bwd needs a 16-byte aligned h_prev')
    if not split:
        return _launch_fused(xw16, h_prev, w16, b32, g32, dxw, dh0)
    r = torch.empty_like(h_prev)
    build.launch('gru_scan_bwd', 'pbsed_gru_scan_bwd', xw.device,
                 xw16.data_ptr(), h_prev.data_ptr(), w16.data_ptr(),
                 b32.data_ptr(), g32.data_ptr(), dxw.data_ptr(),
                 r.data_ptr(), dh0.data_ptr(), d, b, t, hdim)
    dw_hh, db_hh = _weight_grads(h_prev, dxw, r)
    return dxw, dw_hh, db_hh, dh0


def _launch_fused(xw16, h_prev, w16, b32, g32, dxw, dh0):
    """The fused kernel with its workspace (``csrc/gru_bwd_fused.cu``):
    per sweep block (32 rows up to H = 256, 16 above) a zeroed f32
    (H, 3H) dw_hh slice, an f32 (3H,) db_hh slice and a bf16 ring of 16
    steps of h_prev and dgates rows."""
    d, b, t, three_h = xw16.shape
    hdim = three_h // 3
    rows = 32 if hdim <= 256 else 16
    parts = d * -(-b // rows)
    dev = xw16.device
    dw_part = torch.zeros((parts, hdim, three_h), dtype=torch.float32,
                          device=dev)
    db_part = torch.empty((parts, three_h), dtype=torch.float32, device=dev)
    scratch = torch.empty((parts, 16 * rows, 4 * hdim), dtype=torch.bfloat16,
                          device=dev)
    dw_hh = torch.empty((d, hdim, three_h), dtype=torch.float32, device=dev)
    db_hh = torch.empty((d, three_h), dtype=torch.float32, device=dev)
    build.launch('gru_scan_bwd_fused', 'pbsed_gru_scan_bwd_fused', dev,
                 xw16.data_ptr(), h_prev.data_ptr(), w16.data_ptr(),
                 b32.data_ptr(), g32.data_ptr(), dxw.data_ptr(),
                 dw_hh.data_ptr(), db_hh.data_ptr(), dh0.data_ptr(),
                 dw_part.data_ptr(), db_part.data_ptr(), scratch.data_ptr(),
                 d, b, t, hdim)
    return dxw, dw_hh, db_hh, dh0


class GruScan(torch.autograd.Function):
    """:func:`gru_scan` with its backward (:func:`gru_scan_bwd`). Saves
    what the forward already has: xw, the weights, h0 and the f32
    output y (the gates are recomputed in the backward)."""

    @staticmethod
    def forward(ctx, xw, w_hh, b_hh, h0):
        y = gru_scan(xw, w_hh, b_hh, h0)
        ctx.save_for_backward(xw, w_hh, b_hh, h0, y)
        return y

    @staticmethod
    def backward(ctx, g):
        xw, w_hh, b_hh, h0, y = ctx.saved_tensors
        dxw, dw_hh, db_hh, dh0 = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g)
        return (dxw.to(xw.dtype), dw_hh.to(w_hh.dtype),
                db_hh.to(b_hh.dtype), dh0.to(h0.dtype))
