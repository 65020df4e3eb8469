"""GRU recurrence kernels, forward (``csrc/gru.cu``) and backward
(``csrc/gru_bwd.cu``, and the fused ``csrc/gru_bwd_fused.cu``), with
their plain PyTorch versions and the autograd Function ``GruScan`` that
ties them together.

The forward and both backwards each have two designs up to H = 512,
chosen by shape inside the C entry points (``csrc/gru_cluster.cuh``:
``gru_fwd_cluster_takes``, ``gru_cluster_takes``): with few rows and
many steps (training, tagging) at H = 256 and 512 (the backwards at 512
at any shape) a thread-block cluster of H / 32 blocks per row tile of 16
or 32 that keeps w_hh in its shared memory; else the wgmma rows designs
(``csrc/gru_rows.cuh`` forward, ``csrc/gru_bwd_rows.cuh`` backwards: a
cluster of H / 32 blocks per tile of 64 rows, each block's slice of w_hh
resident, the products on wgmma, the backwards up to H = 256).
Above H = 512 the forward and the split backward run the cluster design
with 16 blocks of H / 16 units (``csrc/gru_cluster_wide.cuh``, up to
2048), which streams the part of w_hh that does not fit the blocks'
shared memory from L2 at every step; above 2048, with no upper limit but
the card's memory, the grid design (``csrc/gru_grid.cuh``: one persistent
block an SM, launched cooperatively, the blocks of a direction splitting
its units, the state or the backward's dgates exchanged through a global
buffer under one grid-wide barrier a step). The fused backward stops at
``GRU_FUSED_MAX_HIDDEN``. :func:`gru_designs` reports the choice.

The kernels take H a multiple of 32 up to 512, of 256 up to 2048 and of
64 above. The wrappers take any H >= 1 (the fused backward's up to its
limit) and pad the others exactly
(:func:`pad_hidden`): zero units appended to each gate block keep h = 0
at every step (r = z = 1/2, n = 0) and reach the real units only through
zero rows of w_hh; the padding is sliced off the outputs and gradients
(:func:`unpad_hidden`). The width padded to is the next one the kernels
take (:func:`padded_hidden`), or 256 / 512 where the cluster design takes
that width at the shape and is the faster there (:func:`kernel_hidden`).

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

Under ``torch.func.vmap`` (a stacked ensemble, ``models/base/
ensemble.py``) ``GruScan`` folds the N members into the direction axis:
one ``gru_scan`` at D = N * D_member, since the kernel takes per-D
weights (the FBCRNN's paired heads and a bidirectional layer at D = 2N).
"""
import ctypes

import torch
import torch.nn.functional as F

from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.functions import (cache_signature,
                                                    members_first)

# the largest H the fused backward takes (the forward and the split
# backward take any)
GRU_FUSED_MAX_HIDDEN = 512
# the C entry points run the design of 16 blocks of H / 16 units above
# this H (kWideMinH), at a multiple of _WIDE_STEP (wmma's 16-column tiles
# of each block's units: kWideStep)
_WIDE_ABOVE = 512
_WIDE_STEP = 256
# above this H (kGridMinH, the wide design's kWideMaxH) the grid design
# (pbsed_gru_scan_grid, pbsed_gru_scan_bwd_grid), at a multiple of
# _GRID_STEP (its K chunk: kGridStep)
_GRID_ABOVE = 2048
_GRID_STEP = 64


def padded_hidden(h):
    """The next H from hidden size ``h`` that the kernels take: a multiple
    of 32 up to 512, of 256 up to 2048 (600 -> 768), of 64 above (3000 ->
    3008)."""
    step = (32 if h <= _WIDE_ABOVE else _WIDE_STEP if h <= _GRID_ABOVE
            else _GRID_STEP)
    return -(-h // step) * step


# the backwards run a hidden size from 129 to 255 as 256 on the cluster
# design (where it takes 256 at the shape) only above this one: up to it
# the wgmma rows design at the real width is the faster. Split sweep ms
# at (2, 32, 500, H), rows at H against the cluster design at 256
# (scripts/perf/gru_bwd_designs.py; NVIDIA H100 80GB HBM3, 700 W): 128
# 1.781 vs 2.316, 160 2.035 vs 2.338, 192 2.262 vs 2.285, 224 2.490 vs
# 2.284
_BWD_AS_256_ABOVE = 192


def kernel_hidden(d, b, t, h, name='fwd'):
    """The H the kernels run hidden size ``h`` at, for pass ``name``
    ('fwd', 'bwd' or 'bwd_fused') at xw (D, B, T, 3H): 512 for
    256 < h < 512 where the cluster design takes 512 (the backwards take
    it at every shape: their wgmma rows design stops at 256), 256 for
    128 < h < 256 where the cluster design takes 256 and is the faster
    there (the forward at few rows; the backwards above
    ``_BWD_AS_256_ABOVE``), else :func:`padded_hidden` (above 512 the next
    multiple of 256, above 2048 of 64)."""
    for width in (256, 512):
        low = width // 2
        if width == 256 and name != 'fwd':
            low = _BWD_AS_256_ABOVE
        if (low < h < width
                and _design(name, d, b, t, width)['design'] == 'cluster'):
            return width
    return padded_hidden(h)


def _pad_gates(x, h, hp):
    """``(..., 3h)`` -> ``(..., 3hp)``: zeros appended to each of the r, z
    and n blocks, so the gate order is kept."""
    if hp == h:
        return x
    x = x.reshape(*x.shape[:-1], 3, h)
    return F.pad(x, (0, hp - h)).reshape(*x.shape[:-2], 3 * hp)


def _unpad_gates(x, h):
    """``(..., 3hp)`` -> ``(..., 3h)``: the first h of each gate block."""
    hp = x.shape[-1] // 3
    if hp == h:
        return x
    return x.reshape(*x.shape[:-1], 3, hp)[..., :h].reshape(
        *x.shape[:-1], 3 * h)


def pad_hidden(xw, w_hh, b_hh, h0, *states, hp):
    """The GRU's operands at hidden size ``hp`` >= H: ``xw`` (D, B, T, 3H),
    ``w_hh`` (D, H, 3H) and ``b_hh`` (D, 3H) with zeros appended to each
    gate block (and ``w_hh`` with zero rows), ``h0`` and each of
    ``states`` ((..., H): the backward's y and g) with zero units. A
    padded unit starts at h = 0 and stays there: its r and z are
    sigmoid(0) = 1/2 and its n tanh(0) = 0, so its new h is 1/2 * 0 +
    1/2 * 0; it feeds the real units through zero rows of w_hh only."""
    h = h0.shape[-1]
    w = _pad_gates(w_hh, h, hp)
    return (_pad_gates(xw, h, hp), F.pad(w, (0, 0, 0, hp - h)),
            _pad_gates(b_hh, h, hp),
            *(F.pad(s, (0, hp - h)) for s in (h0, *states)))


def unpad_hidden(h, y=None, dxw=None, dw_hh=None, db_hh=None, dh0=None):
    """The real units' part of padded outputs (each optional; None stays
    None): y and dh0 ``(..., hp)`` -> ``(..., H)``, dxw and db_hh ``(...,
    3hp)`` -> ``(..., 3H)``, dw_hh (D, hp, 3hp) -> (D, H, 3H)."""
    def units(x):
        return None if x is None else x[..., :h].contiguous()

    def gates(x):
        return None if x is None else _unpad_gates(x, h).contiguous()

    return (units(y), gates(dxw),
            None if dw_hh is None else gates(dw_hh[:, :h]), gates(db_hh),
            units(dh0))


def pack_wide(w16):
    """``w_hh`` (D, H, 3H) bf16 as the cluster design above H = 512 reads
    it (``csrc/gru_cluster_wide.cuh``): (D, 16, H, 3H / 16 + 8), block c's
    slice ``w_hh[:, cols(U_c)]`` (the r, z and n columns of its U = H / 16
    units side by side) row-major with 8 values of padding a row, so that
    the slice is one contiguous range and a stage of its ring one bulk
    copy."""
    d, h, _ = w16.shape
    u = h // 16
    w = w16.reshape(d, h, 3, 16, u).permute(0, 3, 1, 2, 4).reshape(
        d, 16, h, 3 * u)
    return F.pad(w, (0, 8)).contiguous()


def pack_grid(w16, dh=False):
    """``w_hh`` (D, H, 3H) bf16 as the grid design above H = 2048 reads it
    (``csrc/gru_grid.cuh``): by unit tile of 16 and K chunk of 64, so that
    a chunk of a tile is one contiguous range (one bulk copy), each 8 x 8
    matrix of its ldmatrix loads 128 contiguous bytes. For the gate product
    (the forward, the backward's recompute): (D, H / 16, H / 64, 8, 3, 2,
    8, 8), tile j's rows k = 64 kc + 8 kb + kr of its gate g's units 16 j +
    8 nh + n at [d, j, kc, kb, g, nh, kr, n]; with ``dh``, for the
    backward's dh product: (D, H / 16, 3H / 64, 8, 2, 8, 8), tile j's rows
    16 j + 8 uh + ur at columns c = 64 kc + 8 cb + c8 at [d, j, kc, cb, uh,
    ur, c8]."""
    d, h, g3 = w16.shape
    if dh:
        return w16.reshape(d, h // 16, 2, 8, g3 // 64, 8, 8).permute(
            0, 1, 4, 5, 2, 3, 6).contiguous()
    return w16.reshape(d, h // 64, 8, 8, 3, h // 16, 2, 8).permute(
        0, 5, 1, 2, 4, 6, 3, 7).contiguous()


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
    hdim = _hidden(h0, None, 'GRU kernel')
    hp = kernel_hidden(*xw.shape[:3], hdim)
    xw16, w16, b32, h32 = pad_hidden(
        xw.to(torch.bfloat16), w_hh.to(torch.bfloat16), b_hh.float(),
        h0.float(), hp=hp)
    xw16, w16, b32, h32 = (a.contiguous() for a in (xw16, w16, b32, h32))
    if _WIDE_ABOVE < hp <= _GRID_ABOVE:
        w16 = pack_wide(w16)
    elif hp > _GRID_ABOVE:
        w16 = pack_grid(w16)
    d, b, t, _ = xw16.shape
    y = torch.empty((d, b, t, hp), dtype=torch.float32, device=xw.device)
    if xw16.data_ptr() % 16 or w16.data_ptr() % 16:
        raise ValueError('gru_scan needs 16-byte aligned xw and w_hh '
                         'buffers')
    ptrs = (xw16.data_ptr(), w16.data_ptr(), b32.data_ptr(), h32.data_ptr(),
            y.data_ptr())
    if hp > _GRID_ABOVE:
        ws = _grid_workspace(d, b, hp, xw.device)
        build.launch('gru_scan', 'pbsed_gru_scan_grid', xw.device, *ptrs,
                     ws.data_ptr(), d, b, t, hp)
    else:
        build.launch('gru_scan', 'pbsed_gru_scan', xw.device, *ptrs, d, b, t,
                     hp)
    _count_shape('gru_scan', hdim, hp)
    _count_rows('gru_scan_rows', 'fwd', d, b, t, hp)
    return unpad_hidden(hdim, y=y)[0]


def _count_rows(counter, name, d, b, t, hp):
    """Count a launch of pass ``name`` that ran the wgmma rows design
    under ``counter`` too."""
    if hp <= _WIDE_ABOVE and _design(name, d, b, t, hp)['design'] == ROWS:
        build.LAUNCHES[counter] += 1


def _count_shape(counter, hdim, hp):
    """Count a launch at a padded H, above H = 512 up to 2048 (the design
    of 16 blocks of H / 16 units) or above 2048 (the grid design) under
    ``<counter>_padded``, ``<counter>_wide`` or ``<counter>_grid`` too."""
    if hp != hdim:
        build.LAUNCHES[f'{counter}_padded'] += 1
    if _WIDE_ABOVE < hp <= _GRID_ABOVE:
        build.LAUNCHES[f'{counter}_wide'] += 1
    if hp > _GRID_ABOVE:
        build.LAUNCHES[f'{counter}_grid'] += 1


def _grid_workspace(d, b, hp, device, backward=False):
    """The grid design's workspace (``csrc/gru_grid.cuh``): 256 bytes for
    its barrier's counter, then the exchanged bf16 state (2, D, B, H), or
    the backward's dgates (2, D, B, 3H)."""
    width = 3 * hp if backward else hp
    return torch.empty(256 + 2 * 2 * d * b * width, dtype=torch.uint8,
                       device=device)


def _hidden(h0, limit, what):
    """H of the operands, checked against the kernel's ``limit`` (None:
    no upper limit)."""
    hdim = h0.shape[-1]
    if hdim < 1 or (limit is not None and hdim > limit):
        bounds = '1 <= H' if limit is None else f'1 <= H <= {limit}'
        raise ValueError(f'the {what} takes {bounds}; got H={hdim}')
    return hdim


_DESIGN_QUERIES = {'fwd': 'pbsed_gru_design', 'bwd': 'pbsed_gru_bwd_design',
                   'bwd_fused': 'pbsed_gru_bwd_fused_design'}
# the design names, by the queries' return codes
ROWS = 'wgmma_rows'
GRID = 'grid'
_DESIGNS = {1: 'cluster', 2: ROWS, 3: GRID}


def _design(name, d, b, t, h):
    lib = build.lib()
    out = [ctypes.c_int() for _ in range(7)]
    rc = getattr(lib, _DESIGN_QUERIES[name])(d, b, t, h,
                                             *map(ctypes.byref, out))
    if rc < 0:
        msg = lib.pbsed_error_string(-rc).decode()
        raise RuntimeError(f'GRU {name} design query at {(d, b, t, h)} '
                           f'failed: CUDA error {-rc} ({msg})')
    return dict(zip(('cluster', 'rows', 'smem', 'coresident', 'units',
                     'resident', 'streamed'), (v.value for v in out)),
                design=_DESIGNS[rc])


def gru_designs(d, b, t, h):
    """Which kernels the GRU runs on the card at xw (D, B, T, 3H), as the
    C entry points decide at the H each pass runs (:func:`kernel_hidden`):
    for ``'fwd'``, ``'bwd'`` (the split backward) and ``'bwd_fused'`` a dict
    of ``design`` ('cluster': w_hh spread over a thread-block cluster's
    shared memory, rows in tiles of 16 or 32, ``csrc/gru_cluster.cuh``
    and above H = 512 ``csrc/gru_cluster_wide.cuh``; ``ROWS``,
    'wgmma_rows': the same spread, tiles of 64 rows on wgmma,
    ``csrc/gru_rows.cuh`` forward and ``csrc/gru_bwd_rows.cuh``
    backwards; ``GRID``, 'grid', above H = 2048: one block an SM, launched
    cooperatively, ``csrc/gru_grid.cuh``), ``hidden`` (the H it runs),
    ``cluster`` (blocks a cluster; the grid design's blocks a direction),
    ``rows`` (batch rows a cluster; the grid design's rows a row tile),
    ``smem`` (dynamic shared memory a block, bytes), ``coresident``
    (clusters the card holds at once; the grid design's blocks of its
    launch), ``units`` (hidden units a block owns: 32, H / 16 above 512,
    those of the largest block above 2048), ``resident`` and ``streamed``
    (bytes of a block's slice of w_hh kept in its shared memory and read
    from L2 at every step);
    ``'bwd_fused'`` is None above ``GRU_FUSED_MAX_HIDDEN``. Raises where
    the card can hold no cluster of the design."""
    out = {}
    for name in _DESIGN_QUERIES:
        if name == 'bwd_fused' and padded_hidden(h) > GRU_FUSED_MAX_HIDDEN:
            out[name] = None
            continue
        hp = kernel_hidden(d, b, t, h, name)
        out[name] = dict(_design(name, d, b, t, hp), hidden=hp)
    return out


def _check_bwd(xw, w_hh, b_hh, h0, y, g):
    _check(xw, w_hh, b_hh, h0)
    want = tuple(h0.shape[:2]) + (xw.shape[2], h0.shape[-1])
    for name, t in (('y', y), ('g', g)):
        if tuple(t.shape) != want:
            raise ValueError(f'{name} shape {tuple(t.shape)} != {want}')
        if t.device != xw.device:
            raise ValueError('all GRU operands must be on one device')


def _h_prev(h0, y, pad=0):
    """(D, B, T, H) bf16 state before each step: concat(h0, y[:-1]),
    contiguous, followed in memory by ``pad`` rows of H zeros."""
    d, b, t, h = y.shape
    n = d * b * t * h
    buf = torch.empty(n + pad * h, dtype=torch.bfloat16, device=y.device)
    buf[n:].zero_()
    h_prev = buf[:n].view(d, b, t, h)
    if t:
        h_prev[:, :, 0] = h0.float()
        h_prev[:, :, 1:] = y[:, :, :t - 1]
    return h_prev


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
    hdim = _hidden(h0, None if split else GRU_FUSED_MAX_HIDDEN,
                   'GRU backward kernel' if split
                   else 'fused GRU backward kernel')
    hp = kernel_hidden(*xw.shape[:3], hdim, 'bwd' if split else 'bwd_fused')
    xw16, w16, b32, h0, y, g32 = pad_hidden(
        xw.to(torch.bfloat16), w_hh.to(torch.bfloat16), b_hh.float(), h0,
        y, g.float(), hp=hp)
    xw16, w16, b32, g32 = (a.contiguous() for a in (xw16, w16, b32, g32))
    w_dh = None
    if _WIDE_ABOVE < hp <= _GRID_ABOVE:
        w16 = pack_wide(w16)
    elif hp > _GRID_ABOVE:
        w16, w_dh = pack_grid(w16), pack_grid(w16, dh=True)
    d, b, t, _ = xw16.shape
    # the fused sweeps read up to 15 steps past the last row
    h_prev = _h_prev(h0, y, pad=0 if split else 16)
    dxw = torch.empty_like(xw16)
    dh0 = torch.empty((d, b, hp), dtype=torch.float32, device=xw.device)
    if h_prev.data_ptr() % 16 or w16.data_ptr() % 16:
        raise ValueError('gru_scan_bwd needs 16-byte aligned h_prev and '
                         'w_hh buffers')
    if not split:
        out = _launch_fused(xw16, h_prev, w16, b32, g32, dxw, dh0)
        return unpad_hidden(hdim, None, *out)[1:]
    r = torch.empty_like(h_prev)
    outs = (g32.data_ptr(), dxw.data_ptr(), r.data_ptr(), dh0.data_ptr())
    if hp > _GRID_ABOVE:
        ws = _grid_workspace(d, b, hp, xw.device, backward=True)
        build.launch('gru_scan_bwd', 'pbsed_gru_scan_bwd_grid', xw.device,
                     xw16.data_ptr(), h_prev.data_ptr(), w16.data_ptr(),
                     w_dh.data_ptr(), b32.data_ptr(), *outs, ws.data_ptr(),
                     d, b, t, hp)
    else:
        build.launch('gru_scan_bwd', 'pbsed_gru_scan_bwd', xw.device,
                     xw16.data_ptr(), h_prev.data_ptr(), w16.data_ptr(),
                     b32.data_ptr(), *outs, d, b, t, hp)
    _count_shape('gru_scan_bwd', hdim, hp)
    _count_rows('gru_scan_bwd_rows', 'bwd', d, b, t, hp)
    dw_hh, db_hh = _weight_grads(h_prev, dxw, r)
    return unpad_hidden(hdim, None, dxw, dw_hh, db_hh, dh0)[1:]


def _launch_fused(xw16, h_prev, w16, b32, g32, dxw, dh0):
    """The fused kernel with its workspace (``csrc/gru_bwd_fused.cu``):
    per (direction, row tile of the design's rows) an f32 (H, 3H) dw_hh
    partial, an f32 (3H,) db_hh partial and a bf16 ring of 16 steps of
    dgates rows."""
    d, b, t, three_h = xw16.shape
    hdim = three_h // 3
    design = _design('bwd_fused', d, b, t, hdim)
    rows = design['rows']
    parts = d * -(-b // rows)
    dev = xw16.device
    dw_part = torch.empty((parts, hdim, three_h), dtype=torch.float32,
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
    if design['design'] == ROWS:
        build.LAUNCHES['gru_scan_bwd_fused_rows'] += 1
    return dxw, dw_hh, db_hh, dh0


@cache_signature
class GruScan(torch.autograd.Function):
    """:func:`gru_scan` with its backward (:func:`gru_scan_bwd`). Saves
    what the forward already has: xw, the weights, h0 and the f32
    output y (the gates are recomputed in the backward). Under
    ``torch.func.vmap`` the members fold into D: one launch for all."""

    @staticmethod
    def forward(xw, w_hh, b_hh, h0):
        return gru_scan(xw, w_hh, b_hh, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def vmap(info, in_dims, xw, w_hh, b_hh, h0):
        args = members_first(info, in_dims, (xw, w_hh, b_hh, h0))
        n, d = args[0].shape[:2]
        y = gru_scan(*(a.reshape(n * d, *a.shape[2:]) for a in args))
        return y.reshape(n, d, *y.shape[1:]), 0

    @staticmethod
    def backward(ctx, g):
        xw, w_hh, b_hh, h0, y = ctx.saved_tensors
        dxw, dw_hh, db_hh, dh0 = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g)
        return (dxw.to(xw.dtype), dw_hh.to(w_hh.dtype),
                db_hh.to(b_hh.dtype), dh0.to(h0.dtype))
