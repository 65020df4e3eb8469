"""2-D conv tower kernels: the stride-1 SAME conv (any kernel extent, any
Cout), the same conv with batch norm and ReLU folded into its input load
(the ``fuse_bn`` tower), the (2, 1) freq max-pool, the max pool of any
window, the (2, 1) freq average pool that matches a residual across a pool
and the average pool of any window, forward and backward, each as a
hand-written CUDA kernel with its plain PyTorch version beside it, and the
autograd Functions that tie each forward to its backward (``Conv2dSame``,
``BnReluConv2dSame``, ``MaxPoolFreq2``, ``MaxPool2d``, ``AvgPoolFreq2``,
``AvgPool2d``); and the same conv in float32 for a
``compute_dtype='float32'`` tower (``Conv2dSameF32``: any extent and
width, ``csrc/conv2d_f32.cu``: 3xTF32 on the tensor cores, on mma.sync at
Cin < 16 and for the dx of Cout < 16 (``csrc/conv2d_f32_entry.cuh``),
on wgmma's tiles of rows x W pixels everywhere else
(``csrc/conv2d_f32_wgmma.cuh``: Cin and Cout padded with zeros to what
its TMA copies take, :func:`_f32_channels`; kernels whose halo fits no
tile as f32 sums of tap blocks, :func:`_f32_tap_blocks`);
:func:`conv_f32_designs` says which).

The conv kernels take odd extents, Cout a multiple of 16 and Cin below
16 or a multiple of 8 (the wgmma ring's TMA loads need 16-byte rows). The
wrappers give them every other shape exactly: an even extent k with
XLA's SAME pads ``((k - 1) // 2, k // 2)`` is the odd extent k + 1 with a
zero tap first and the symmetric pad k // 2, and Cout is padded with zero
weight columns and zero bias up to a multiple of 16
(:func:`_kernel_weights`); the extra output channels are sliced off, the
cotangent is padded with zeros (so they add nothing to dx), and the dw of
the padded tap and columns is dropped. From Cin = 16 up, Cin off a
multiple of 8 is padded with zero channels and zero weight rows
(:func:`_kernel_channels`); dx and dw of those channels are dropped. A
kernel whose halo fits no tile in shared memory (extents of a few dozen
taps) runs as the sum of tap blocks that fit (:func:`_tap_blocks`), each
launched on the input widened by its offset.

A stacked ensemble (``models/base/ensemble.py``) calls the Functions
under ``torch.func.vmap`` over its members; each Function's ``vmap`` rule
takes the members in ONE launch (the batching that ``jax.vmap`` gives the
TPU kernels): the forward convs on their member axis
(:func:`conv2d_same_members`, :func:`bnrelu_conv2d_same_members`: x
``(M, B, T, F, Cin)``, w ``(M, kt, kf, Cin, Cout)``, b ``(M, Cout)``,
scale and shift ``(M, Cin)``), the pools on ``M * B`` clips. The stacked
lane serves only; its backward is not ported.

All work on the channels-last ``(B, T, F, C)`` layout of the tower and
keep the JAX package's parameter layout (conv kernel HWIO
``(kt, kf, Cin, Cout)``). On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches the kernel (``csrc/conv2d.cu``,
``csrc/conv2d_bwd.cu``, ``csrc/maxpool.cu``, ``csrc/avgpool.cu``) or
raises. The Functions' backward calls the backward wrapper, so on the
CPU the tests reach the plain backward's own formula (tie rule, rounding
points), not autograd of the plain forward.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.functions import (cache_signature,
                                                    full_f32, members_first)


def _check_conv(x, w, b, dtype=torch.bfloat16, name='conv2d_same'):
    if x.dtype != dtype:
        raise TypeError(f'{name} takes a {str(dtype)[6:]} input, got '
                        f'{x.dtype}')
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f'expected x (B, T, F, Cin) and w (kt, kf, Cin, '
                         f'Cout), got {tuple(x.shape)} and {tuple(w.shape)}')
    kt, kf, cin, cout = w.shape
    if min(kt, kf, cout) < 1:
        raise ValueError(f'empty kernel {tuple(w.shape)}')
    if x.shape[-1] != cin:
        raise ValueError(f'input has {x.shape[-1]} channels, kernel {cin}')
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f'bias shape {tuple(b.shape)} != ({cout},)')
    if not w.is_floating_point() or (b is not None
                                     and not b.is_floating_point()):
        raise TypeError('weights and bias must be floating point')
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError('x, w and b must be on one device')


def _same_pads(kt, kf, flip=False):
    """``F.pad`` widths (freq, then time) of XLA's SAME pads for a stride-1
    kt x kf kernel, ``((k - 1) // 2, k // 2)`` on each axis; ``flip``
    swaps the two sides (the input gradient's transposed conv)."""
    out = []
    for k in (kf, kt):
        lo, hi = (k - 1) // 2, k // 2
        out += [hi, lo] if flip else [lo, hi]
    return tuple(out)


def _conv_same(x, w, flip=False):
    """``F.conv2d`` of NCHW ``x`` and OIHW ``w`` with XLA's SAME pads: the
    symmetric ``padding`` for odd extents, an explicit pad for even ones."""
    kt, kf = w.shape[2:]
    if kt % 2 and kf % 2:
        return F.conv2d(x, w, padding=((kt - 1) // 2, (kf - 1) // 2))
    return F.conv2d(F.pad(x, _same_pads(kt, kf, flip)), w)


def conv2d_same_plain(x, w, b):
    """Plain version: bf16-rounded operands in f32, f32 bias, one final
    rounding to bf16 (the order of the TPU kernel's epilogue)."""
    xf = x.float().permute(0, 3, 1, 2)                       # (B, Cin, T, F)
    wf = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)    # OIHW
    y = _conv_same(xf, wf)
    if b is not None:
        y = y + b.float()[None, :, None, None]
    return y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def conv2d_same(x, w, b):
    """Stride-1 SAME conv (XLA's pads): ``(B, T, F, Cin)`` bf16 ->
    ``(B, T, F, Cout)`` bf16 with f32 accumulation and f32 bias.

    Args:
        x: (B, T, F, Cin) bfloat16 activations (any Cin >= 1).
        w: (kt, kf, Cin, Cout) weights (rounded to bf16), any extents and
            Cout.
        b: (Cout,) bias (f32) or None.
    """
    _check_conv(x, w, b)
    if x.device.type == 'cpu':
        return conv2d_same_plain(x, w, b)
    return _launch_conv('conv2d_same', x[None], w[None],
                        None if b is None else b[None], padded=True)[0]


def _kernel_weights(w, b=None):
    """``w (..., kt, kf, Cin, Cout)`` and ``b (..., Cout)`` as the conv
    kernels take them: an even extent with one zero tap put first (XLA's
    SAME pads ``((k - 1) // 2, k // 2)`` are then the kernel's symmetric
    ``k // 2``), Cout padded with zero columns and zero bias to a multiple
    of 16. Odd extents at a multiple of 16 come back as they are."""
    kt, kf, _, cout = w.shape[-4:]
    grow = -cout % 16
    if kt % 2 and kf % 2 and not grow:
        return w, b
    w = F.pad(w, (0, grow, 0, 0, 1 - kf % 2, 0, 1 - kt % 2, 0))
    return w, None if b is None else F.pad(b, (0, grow))


def _kernel_channels(x, w, affine=()):
    """``x (..., Cin)``, ``w (..., kt, kf, Cin, Cout)`` and each of
    ``affine`` (scale, shift: ``(..., Cin)``) as the wgmma kernels take
    them: from Cin = 16 up, Cin padded with zero channels, zero weight
    rows and zero scale and shift to a multiple of 8 (the TMA copies' rows
    are 16-byte multiples). A padded channel is 0 after the fused affine
    too and meets zero weights, so the output is the unpadded one in every
    bit; its dx and dw are dropped. Below 16 (the entry kernels take any
    count) and at multiples of 8 the operands come back as they are."""
    cin = x.shape[-1]
    grow = -cin % 8 if cin >= 16 else 0
    if not grow:
        return x, w, tuple(affine)
    return (F.pad(x, (0, grow)), F.pad(w, (0, 0, 0, grow)),
            tuple(F.pad(a, (0, grow)) for a in affine))


def _pass_queries(cin, cout):
    """The C design query of each pass and the (Cin, N) it takes: the
    forward and the dx are forward-type GEMMs (the dx from Cout to Cin
    channels), the dw has a query of its own."""
    return {'fwd': ('pbsed_conv2d_design', cin, cout),
            'dx': ('pbsed_conv2d_design', cout, cin),
            'dw': ('pbsed_conv2d_dw_design', cin, cout)}


def _halved_block(kt, kf, fits, what):
    """The largest tap block (bt, bf) of a kt x kf kernel that ``fits``:
    (kt, kf) where the whole kernel does, else the longer side halved
    (rounded up) until it fits; raises, naming ``what``, where not even a
    1 x 1 block does."""
    bt, bf = kt, kf
    while not fits(bt, bf):
        if bt == bf == 1:
            raise ValueError(f'no conv kernel takes {what} at a 1x1 kernel')
        if bt >= bf:
            bt = (bt + 1) // 2
        else:
            bf = (bf + 1) // 2
    return bt, bf


@functools.lru_cache(maxsize=None)
def _tap_blocks(f, cin, cout, kt, kf, passes):
    """The largest tap block (bt, bf) of a (F, Cin -> Cout, kt x kf) conv
    whose ``passes`` ('fwd', 'dx', 'dw') all run on a kernel, the
    extents and channels padded as the wrappers pad them: (kt, kf) where
    the whole kernel fits, else the longer side halved (rounded up) until
    each pass's halo ring fits shared memory (kernels of ~29 x 29 taps and
    more at the dw, ~60 x 60 at the forward). Such a conv runs as the sum
    of its tap blocks (:func:`_conv_by_blocks`,
    :func:`_conv_bwd_by_blocks`)."""
    cin += -cin % 8 if cin >= 16 else 0
    cout += -cout % 16
    queries = _pass_queries(cin, cout)
    return _halved_block(
        kt, kf, lambda bt, bf: all(
            _design(queries[p][0], f, *queries[p][1:], bt + 1 - bt % 2,
                    bf + 1 - bf % 2)[0] is not None for p in passes),
        f'F = {f}, {cin} -> {cout} channels')


def _blocks(kt, kf, bt, bf):
    """The tap blocks of a kt x kf kernel cut into blocks of at most bt x
    bf taps: (t0, f0, at, af, dt, df) for the block of taps [t0, t0 + at)
    x [f0, f0 + af), whose own SAME conv reads, at each output, the input
    moved by (dt, df) as those taps read it in the whole conv (XLA's SAME
    pads put tap i of k at offset i - (k - 1) // 2)."""
    for t0 in range(0, kt, bt):
        for f0 in range(0, kf, bf):
            at, af = min(bt, kt - t0), min(bf, kf - f0)
            yield (t0, f0, at, af, t0 - (kt - 1) // 2 + (at - 1) // 2,
                   f0 - (kf - 1) // 2 + (af - 1) // 2)


def _widen(x, dt, df):
    """``x (..., T, F, C)`` with |dt| zero frames and |df| zero bins put
    before it where the offset is negative, after it where positive: a
    block's SAME conv of it, narrowed by the same offset (:func:`_narrow`),
    reads the input moved by (dt, df), zeros outside the input included."""
    return F.pad(x, (0, 0, max(-df, 0), max(df, 0), max(-dt, 0), max(dt, 0)))


def _narrow(z, dt, df, t, f):
    """The (t, f) window of ``z (..., T', F', C)`` from (max(dt, 0),
    max(df, 0)): a conv of :func:`_widen` (x, dt, df) back at the input's
    extents (and, at (-dt, -df), the input gradient of such a conv)."""
    t0, f0 = max(dt, 0), max(df, 0)
    return z[..., t0:t0 + t, f0:f0 + f, :]


def _conv_by_blocks(conv, x, w, b, bt, bf):
    """The SAME conv of ``x (..., T, F, Cin)`` by ``w (..., kt, kf, Cin,
    Cout)`` as the f32 sum over the tap blocks of at most bt x bf taps of
    ``conv(widened x, tap block of w)`` (each in x's dtype), narrowed
    back, plus the f32 bias ``b (..., Cout)``, rounded once to x's dtype:
    bf16 for the bf16 conv, none for the f32 one."""
    kt, kf = w.shape[-4:-2]
    t, f = x.shape[-3:-1]
    y = 0.
    for t0, f0, at, af, dt, df in _blocks(kt, kf, bt, bf):
        y = y + _narrow(conv(_widen(x, dt, df),
                             w[..., t0:t0 + at, f0:f0 + af, :, :]),
                        dt, df, t, f).float()
    if b is not None:
        y = y + b.float()[..., None, None, None, :]
    return y.to(x.dtype)


def _conv_bwd_by_blocks(conv_bwd, x, w, gy, bt, bf, need_dx=True):
    """dx and dw of the SAME conv of ``x (B, T, F, Cin)`` by ``w (kt, kf,
    Cin, Cout)`` from ``conv_bwd(widened x, tap block of w, gy widened
    the other way)`` over the tap blocks of at most bt x bf taps: each
    block's dw is its slice of dw, and dx the f32 sum of the blocks' dx
    (each in x's dtype) narrowed back, rounded once to x's dtype (None
    with ``need_dx=False``)."""
    kt, kf = w.shape[:2]
    t, f = x.shape[1:3]
    dx = torch.zeros(x.shape, device=x.device) if need_dx else None
    dw = torch.empty(w.shape, device=x.device)
    for t0, f0, at, af, dt, df in _blocks(kt, kf, bt, bf):
        dxb, dw[t0:t0 + at, f0:f0 + af] = conv_bwd(
            _widen(x, dt, df), w[t0:t0 + at, f0:f0 + af],
            _widen(gy, -dt, -df))
        if need_dx:
            dx += _narrow(dxb, -dt, -df, t, f).float()
    return None if dx is None else dx.to(x.dtype), dw


def _launch_conv(counter, x, w, b, affine=(), padded=False):
    """Launch ``pbsed_<counter>`` on CUDA tensors with a leading member
    axis (x (M, B, T, F, Cin), w (M, kt, kf, Cin, Cout), b (M, Cout) or
    None): the SAME conv of all M members in one launch, with ``affine =
    (scale, shift)``, each (M, Cin), for the BN+ReLU-fused one. Other
    extents and widths go through :func:`_kernel_weights` and
    :func:`_kernel_channels`; with ``padded`` such a launch counts under
    ``<counter>_padded`` too. A kernel whose halo fits no tile
    (:func:`_tap_blocks`) runs as the sum of its tap blocks, one launch of
    ``pbsed_conv2d_same`` each, the fused one on the post-activation
    buffer :func:`bnrelu_plain` makes first (a widened input's zeros would
    not stay 0 through the affine)."""
    build.require_cuda(x, w, *affine)
    members, bsz, t, f, cin0 = x.shape
    width = w.shape[-1]
    asked = (*w.shape[1:3], cin0, width)
    blocks = _tap_blocks(f, cin0, width, *asked[:2], ('fwd',))
    if blocks != asked[:2]:
        if affine:
            x = bnrelu_plain(x, *(a[:, None, None, None] for a in affine))
        return _conv_by_blocks(
            lambda xs, wb: _launch_conv('conv2d_same', xs, wb, None,
                                        padded=padded), x, w, b, *blocks)
    w, b = _kernel_weights(w, b)
    x, w, affine = _kernel_channels(x, w, affine)
    kt, kf, cin, cout = w.shape[1:]
    design = _design('pbsed_conv2d_design', f, cin, cout, kt, kf)[0]
    x = x.contiguous()
    w16 = w.to(torch.bfloat16).contiguous()
    b32 = (torch.zeros((members, cout), device=x.device) if b is None
           else b.float().contiguous())
    affine = tuple(a.float().contiguous() for a in affine)
    y = torch.empty((members, bsz, t, f, cout), dtype=torch.bfloat16,
                    device=x.device)
    if any(a.data_ptr() % 16 for a in (x, w16, *affine)):
        raise ValueError(f'{counter} needs 16-byte aligned buffers')
    build.launch(counter, f'pbsed_{counter}', x.device,
                 x.data_ptr(), w16.data_ptr(), b32.data_ptr(),
                 *(a.data_ptr() for a in affine), y.data_ptr(),
                 members, bsz, t, f, cin, cout, kt, kf)
    if padded and (kt, kf, cin, cout) != asked:
        build.LAUNCHES[f'{counter}_padded'] += 1
    if f'{counter}_entry' in build.LAUNCHES and design == 'entry':
        build.LAUNCHES[f'{counter}_entry'] += 1
    return y if cout == width else y[..., :width].contiguous()


def _check_members(x, w, b, affine=()):
    """The member-axis operands: x (M, B, T, F, Cin), w (M, kt, kf, Cin,
    Cout), b (M, Cout) or None, each of ``affine`` (M, Cin); each member
    as :func:`_check_conv` (and :func:`_check_affine`) wants it."""
    if x.dim() != 5 or w.dim() != 5:
        raise ValueError(f'expected x (M, B, T, F, Cin) and w (M, kt, kf, '
                         f'Cin, Cout), got {tuple(x.shape)} and '
                         f'{tuple(w.shape)}')
    members = x.shape[0]
    for name, a in (('w', w), ('b', b)) + tuple(
            zip(('scale', 'shift'), affine)):
        if a is not None and a.shape[0] != members:
            raise ValueError(f'{name} has {a.shape[0]} members, x '
                             f'{members}')
    _check_conv(x[0], w[0], None if b is None else b[0])
    if affine:
        _check_affine(x[0], affine[0][0], affine[1][0])


def conv2d_same_members_plain(x, w, b):
    """Plain version of :func:`conv2d_same_members`: each member's
    :func:`conv2d_same_plain`."""
    return torch.stack([conv2d_same_plain(x[m], w[m],
                                          None if b is None else b[m])
                        for m in range(x.shape[0])])


def conv2d_same_members(x, w, b):
    """:func:`conv2d_same` of M stacked members in one launch: member m's
    output is ``conv2d_same(x[m], w[m], b[m])``, bit for bit on the card.

    Args:
        x: (M, B, T, F, Cin) bfloat16 activations.
        w: (M, kt, kf, Cin, Cout) weights (rounded to bf16).
        b: (M, Cout) bias (f32) or None.
    """
    _check_members(x, w, b)
    if x.device.type == 'cpu':
        return conv2d_same_members_plain(x, w, b)
    return _launch_conv('conv2d_same', x, w, b, padded=True)


def _check_conv_bwd(x, w, gy):
    _check_conv(x, w, None)
    want = tuple(x.shape[:3]) + (w.shape[-1],)
    if tuple(gy.shape) != want:
        raise ValueError(f'cotangent shape {tuple(gy.shape)} != {want}')
    if gy.device != x.device:
        raise ValueError('x and gy must be on one device')


def conv2d_same_bwd_plain(x, w, gy, need_dx=True):
    """Plain backward: dx is the SAME conv of the cotangent with the
    spatially flipped, channel-transposed bf16 weights in f32, rounded
    once to bf16 (no bias), or None with ``need_dx=False``; dw the f32
    correlation of the bf16 input with the bf16-rounded cotangent."""
    kt, kf, cin, cout = w.shape
    gf = gy.to(torch.bfloat16).float().permute(0, 3, 1, 2)  # (B, Cout, T, F)
    dx = None
    if need_dx:
        w_flip = w.to(torch.bfloat16).float().flip(0, 1)    # (kt, kf, Ci, Co)
        dx = _conv_same(gf, w_flip.permute(2, 3, 0, 1), flip=True)
        dx = dx.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
    xf = x.float().permute(0, 3, 1, 2)
    if kt % 2 and kf % 2:
        dw = torch.nn.grad.conv2d_weight(
            xf, (cout, cin, kt, kf), gf,
            padding=((kt - 1) // 2, (kf - 1) // 2))
    else:
        dw = torch.nn.grad.conv2d_weight(
            F.pad(xf, _same_pads(kt, kf)), (cout, cin, kt, kf), gf)
    return dx, dw.permute(2, 3, 1, 0).contiguous()


def _dw_workspace(bsz, t, f, cin, cout, kt, kf, device):
    """The dw pass's pixel chunks and its f32 workspace, both as the C
    side sizes them for the kernel the shape runs
    (``csrc/conv2d_entry.cuh:conv2d_dw_chunks``: about four blocks per SM
    for the entry kernel, one wave for the wgmma one;
    ``pbsed_conv2d_dw_workspace``: the elements of its layout)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    lib = build.lib()
    chunks = lib.pbsed_conv2d_dw_chunks(bsz, t, f, cin, cout, kt, kf, sms)
    size = lib.pbsed_conv2d_dw_workspace(f, cin, cout, kt, kf, chunks)
    return chunks, torch.empty(size, dtype=torch.float32, device=device)


# the C design queries' answers (0: no kernel takes the whole kernel)
_DESIGNS = {0: None, 1: 'wgmma', 2: 'entry'}


@functools.lru_cache(maxsize=None)
def _design(query, f, cin, cout, kt, kf):
    """(design, stages, smem) that the C design query ``query``
    (``pbsed_conv2d_design`` or ``pbsed_conv2d_dw_design``) gives a
    shape."""
    stages, smem = ctypes.c_int(), ctypes.c_int()
    code = getattr(build.lib(), query)(f, cin, cout, kt, kf,
                                       ctypes.byref(stages),
                                       ctypes.byref(smem))
    return _DESIGNS[code], stages.value, smem.value


def conv_designs(f, cin, cout, kt=3, kf=3):
    """Which kernels the conv of a (F, Cin -> Cout, kt x kf) layer runs on
    the card, as the C entry points decide: for each pass ``'fwd'``,
    ``'dx'`` and ``'dw'`` a dict of ``design`` ('entry',
    ``csrc/conv2d_entry.cuh``: the forward and dw at Cin < 16; 'wgmma',
    ``csrc/conv2d_wgmma.cuh``: every other pass, the dx at Cin < 16
    included), ``stages`` (the depth of the kernel's activation ring),
    ``smem`` (its dynamic shared memory in bytes) and ``taps`` (the
    extents of the tap block one launch takes: (kt, kf) but where the
    whole kernel's halo fits no tile, :func:`_tap_blocks`; the dx and dw
    share their blocks). Cin and Cout as the kernels take them
    (:func:`_kernel_weights`, :func:`_kernel_channels` pad other counts
    first)."""
    designs = {}
    for name, (query, c_in, c_out) in _pass_queries(cin, cout).items():
        bt, bf = _tap_blocks(f, cin, cout, kt, kf,
                             ('fwd',) if name == 'fwd' else ('dx', 'dw'))
        design, stages, smem = _design(query, f, c_in, c_out,
                                       bt + 1 - bt % 2, bf + 1 - bf % 2)
        designs[name] = {'design': design, 'stages': stages, 'smem': smem,
                         'taps': (bt, bf)}
    return designs


def conv2d_same_bwd(x, w, gy, need_dx=True):
    """Backward of :func:`conv2d_same` w.r.t. x and w.

    Args:
        x: (B, T, F, Cin) bfloat16 forward input.
        w: (kt, kf, Cin, Cout) weights (rounded to bf16).
        gy: (B, T, F, Cout) cotangent of the bf16 output (rounded to
            bf16, as the output's type).
        need_dx: False runs no dx pass (where the input needs no
            gradient); dw is the same in every bit. Every recipe's entry
            layer needs its dx: its input comes through the features'
            learnable affine and ``norm_0``'s learnable scale.

    Returns: dx (B, T, F, Cin) bfloat16 (None with ``need_dx=False``) and
    dw (kt, kf, Cin, Cout) float32. The bias gradient is the f32 sum of
    gy, left to the caller.
    """
    _check_conv_bwd(x, w, gy)
    if x.device.type == 'cpu':
        return conv2d_same_bwd_plain(x, w, gy, need_dx)
    return _launch_conv_bwd('conv2d_same_bwd', x, w, gy, padded=True,
                            need_dx=need_dx)


def _launch_conv_bwd(counter, x, w, gy, affine=(), padded=False,
                     need_dx=True):
    """Launch ``pbsed_<counter>`` on CUDA tensors: dx (or da; None and
    no dx pass with ``need_dx=False``) and dw of the SAME conv, with
    ``affine = (scale, shift)`` f32 pointers after the flipped weights for
    the BN+ReLU-fused one; other extents and widths, and kernels whose
    halo fits no tile, as :func:`_launch_conv` takes them (and counts
    them), the tap blocks' dx and dw from ``pbsed_conv2d_same_bwd``."""
    build.require_cuda(x, w, gy, *affine)
    bsz, t, f, cin0 = x.shape
    kt0, kf0, _, width = w.shape
    blocks = _tap_blocks(f, cin0, width, kt0, kf0,
                         ('dx', 'dw') if need_dx else ('dw',))
    if blocks != (kt0, kf0):
        if affine:
            x = bnrelu_plain(x, *affine)
        return _conv_bwd_by_blocks(
            lambda xs, wb, g: _launch_conv_bwd(
                'conv2d_same_bwd', xs, wb, g, padded=padded,
                need_dx=need_dx), x, w, gy, *blocks, need_dx=need_dx)
    w, _ = _kernel_weights(w)
    x, w, affine = _kernel_channels(x, w, affine)
    kt, kf, cin, cout = w.shape
    design = _design('pbsed_conv2d_dw_design', f, cin, cout, kt, kf)[0]
    x = x.contiguous()
    gy = gy.to(torch.bfloat16)
    if cout != width:
        gy = F.pad(gy, (0, cout - width))
    gy = gy.contiguous()
    dx = w_flip = None
    if need_dx:
        # the dx GEMM's weight rows padded with zero columns to 16 at
        # Cin < 16 (the wgmma kernel's 16-byte TMA strides and its 16-wide
        # weight box)
        w_flip = w.to(torch.bfloat16).flip(0, 1).transpose(2, 3)
        if cin < 16:
            w_flip = F.pad(w_flip, (0, -cin % 16))
        w_flip = w_flip.contiguous()
        dx = torch.empty_like(x)
    dw = torch.empty((kt, kf, cin, cout), dtype=torch.float32,
                     device=x.device)
    chunks, workspace = _dw_workspace(bsz, t, f, cin, cout, kt, kf, x.device)
    if any(a is not None and a.data_ptr() % 16
           for a in (x, gy, w_flip, dx, workspace, *affine)):
        raise ValueError(f'{counter} needs 16-byte aligned buffers')
    build.launch(counter, f'pbsed_{counter}', x.device,
                 x.data_ptr(), gy.data_ptr(),
                 None if w_flip is None else w_flip.data_ptr(),
                 *(a.data_ptr() for a in affine),
                 None if dx is None else dx.data_ptr(),
                 dw.data_ptr(), workspace.data_ptr(),
                 bsz, t, f, cin, cout, kt, kf, chunks)
    if f'{counter}_entry' in build.LAUNCHES and design == 'entry':
        build.LAUNCHES[f'{counter}_entry'] += 1
    if (kt, kf, cin, cout) != (kt0, kf0, cin0, width):
        dw = dw[kt - kt0:, kf - kf0:, :cin0, :width].contiguous()
        if dx is not None and cin != cin0:
            dx = dx[..., :cin0].contiguous()
        if padded:
            build.LAUNCHES[f'{counter}_padded'] += 1
    return dx, dw


@cache_signature
class Conv2dSame(torch.autograd.Function):
    """:func:`conv2d_same` with its backward: dx (only where autograd
    needs it; every recipe's entry layer needs it, its input coming
    through learnable affines) and dw from
    :func:`conv2d_same_bwd`, db the f32 sum of the bf16 cotangent
    (``pb_sed_tpu/ops/pallas/conv.py:959-962``). Under ``torch.func.vmap``
    (a stacked ensemble) all members in one launch,
    :func:`conv2d_same_members`."""

    @staticmethod
    def forward(x, w, b):
        return conv2d_same(x, w, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b = inputs
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        return conv2d_same_members(*members_first(info, in_dims,
                                                  (x, w, b))), 0

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        dx, dw = conv2d_same_bwd(x, w, gy, need_dx=ctx.needs_input_grad[0])
        db = gy.float().sum((0, 1, 2)) if ctx.has_bias else None
        return dx, dw.to(w.dtype), db


# -- the f32 conv (compute_dtype='float32') ----------------------------------

def conv2d_same_f32_plain(x, w, b):
    """Plain version of :func:`conv2d_same_f32`: ``F.conv2d`` of the f32
    operands with XLA's SAME pads, TF32 and cuDNN off (:func:`full_f32`:
    f32 products and sums), plus the f32 bias: the JAX package's
    ``lax.conv_general_dilated`` on f32 operands, then ``+ bias``
    (``pb_sed_tpu/ops/cnn.py:113-119``)."""
    with full_f32(cudnn=False):
        y = _conv_same(x.float().permute(0, 3, 1, 2),
                       w.float().permute(3, 2, 0, 1))
    if b is not None:
        y = y + b.float()[None, :, None, None]
    return y.permute(0, 2, 3, 1).contiguous()


_F32_PASSES = {'fwd': 0, 'dx': 1, 'dw': 2}
# the C design query's answers (0: no kernel takes the whole kernel)
_F32_DESIGNS = {0: None, 1: '3xtf32', 2: 'entry'}


@functools.lru_cache(maxsize=None)
def _f32_design(name, f, cin, cout, kt, kf):
    """(design, stages, smem, (width, rows)) of one pass of the f32 conv
    at the channel counts a launch gives the C entry points, as they
    decide (``pbsed_conv2d_f32_design``); the tile is rows frames of
    width frequencies."""
    out = [ctypes.c_int() for _ in range(4)]
    code = build.lib().pbsed_conv2d_f32_design(
        _F32_PASSES[name], f, cin, cout, kt, kf,
        *(ctypes.byref(v) for v in out))
    stages, smem, width, rows = (v.value for v in out)
    return _F32_DESIGNS[code], stages, smem, (width, rows)


def _f32_channels(cin, cout):
    """(Cin, Cout) as the f32 kernels take a layer's forward and dw: from
    Cin = 16 up (the 3xTF32 pair), Cin padded to a multiple of 4 (TMA's
    rows are 16-byte multiples) and Cout to one that is at least 16;
    below (the entry kernels take any count) as they are."""
    if cin < 16:
        return cin, cout
    return cin + -cin % 4, max(16, cout + -cout % 4)


@functools.lru_cache(maxsize=None)
def _f32_pass_shapes(f, cin, cout, kt, kf):
    """The (Cin, Cout) each pass of an f32 layer launches at
    (:func:`_f32_channels`): the dx of a layer with Cin >= 16 and
    Cout < 16 is a GEMM from Cout < 16 channels, which the entry kernels
    take unpadded where their tile fits; elsewhere the dx reads the
    cotangent padded as the dw does."""
    cin_k, cout_k = _f32_channels(cin, cout)
    cout_dx = cout_k
    if cout < 16 <= cin and _f32_design('dx', f, cin_k, cout, kt,
                                        kf)[0] == 'entry':
        cout_dx = cout
    return {'fwd': (cin_k, cout_k), 'dx': (cin_k, cout_dx),
            'dw': (cin_k, cout_k)}


@functools.lru_cache(maxsize=None)
def _f32_tap_blocks(f, cin, cout, kt, kf, passes):
    """The largest tap block (bt, bf) of a (F, Cin -> Cout, kt x kf) f32
    conv whose ``passes`` ('fwd', 'dx', 'dw') all run on a kernel at
    their launch shapes (:func:`_f32_pass_shapes`): (kt, kf) where the
    whole kernel fits, else the longer side halved (rounded up) until each
    pass's halo ring fits shared memory (f32 halos hold twice bf16's
    bytes: kernels of ~25 x 25 taps and more at 64 channels). Such a conv
    runs as the f32 sum of its tap blocks (:func:`_conv_by_blocks`,
    :func:`_conv_bwd_by_blocks`)."""
    return _halved_block(
        kt, kf, lambda bt, bf: all(
            _f32_design(p, f, *_f32_pass_shapes(f, cin, cout, bt, bf)[p],
                        bt, bf)[0] is not None for p in passes),
        f'F = {f}, {cin} -> {cout} f32 channels')


def conv_f32_designs(f, cin, cout, kt=3, kf=3):
    """Which kernels the f32 conv of a (F, Cin -> Cout, kt x kf) layer runs
    on the card, as the C entry points decide: for each pass ``'fwd'``,
    ``'dx'`` and ``'dw'`` a dict of ``design`` ('entry', mma.sync 3xTF32,
    ``csrc/conv2d_f32_entry.cuh``: all three passes at Cin < 16, and the
    dx at Cout < 16 where it fits; '3xtf32', wgmma on the tensor cores,
    ``csrc/conv2d_f32_wgmma.cuh``: every other pass), ``channels`` (the
    (Cin, Cout) it launches at: :func:`_f32_pass_shapes`), ``stages``
    (the depth of the kernel's activation ring), ``smem`` (its dynamic
    shared memory in bytes), ``tile`` (width, rows: a tile of rows frames
    of width frequencies) and ``taps`` (the extents of the tap block one
    launch takes: (kt, kf) but where the whole kernel's halo fits no
    tile, :func:`_f32_tap_blocks`; the dx and dw share their blocks)."""
    designs = {}
    for name in _F32_PASSES:
        bt, bf = _f32_tap_blocks(f, cin, cout, kt, kf,
                                 ('fwd',) if name == 'fwd' else ('dx', 'dw'))
        channels = _f32_pass_shapes(f, cin, cout, bt, bf)[name]
        design, stages, smem, tile = _f32_design(name, f, *channels, bt, bf)
        designs[name] = {'design': design, 'channels': channels,
                         'stages': stages, 'smem': smem, 'tile': tile,
                         'taps': (bt, bf)}
    return designs


def _f32_split(name, f, cin, cout, kt, kf, members, device):
    """The buffer that pass ``name`` ('fwd' or 'dx', at its launch
    channels) splits the weights into: their tf32 hi and lo parts, laid
    out for its kernel (``pbsed_conv2d_f32_split_floats``)."""
    floats = build.lib().pbsed_conv2d_f32_split_floats(
        _F32_PASSES[name], f, cin, cout, kt, kf, members)
    return torch.empty(floats, dtype=torch.float32, device=device)


def _aligned16(t):
    """``t``, or a copy of it where its data do not start 16-byte aligned
    (a member's view of a stack): the f32 kernels copy activations in
    16-byte units."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_last(t, n):
    """``t`` with zeros after its last dimension's entries up to ``n``."""
    return t if t.shape[-1] == n else F.pad(t, (0, n - t.shape[-1]))


def _f32_padded_conv(conv, x, w, b, cin_k, cout_k):
    """The f32 conv of x (..., Cin), w (..., kt, kf, Cin, Cout), b (...,
    Cout) or None as ``conv`` of the operands padded to ``cin_k`` and
    ``cout_k`` channels: zero input channels meeting zero weight rows, and
    zero weight columns and zero bias for the extra outputs, which are
    dropped. Zero products add nothing, so the output is the unpadded
    conv's within the kernels' summation order."""
    cout = w.shape[-1]
    x = _pad_last(x, cin_k)
    w = F.pad(w, (0, cout_k - cout, 0, cin_k - w.shape[-2]))
    b = None if b is None else _pad_last(b, cout_k)
    y = conv(x, w, b)
    return y if cout_k == cout else y[..., :cout].contiguous()


def _f32_padded_conv_bwd(conv_bwd, x, w, gy, shapes, need_dx=True):
    """dx and dw of the f32 conv of x (B, T, F, Cin) by w (kt, kf, Cin,
    Cout) from ``conv_bwd(x, gy, gy_dx, w_dx, need_dx)`` at the padded
    launch shapes ``shapes`` (:func:`_f32_pass_shapes`): x and w padded to
    the dw's (Cin, Cout) and gy with zero channels to its Cout (they add
    nothing to dw and dx), the dx's cotangent ``gy_dx`` and weights
    ``w_dx`` (kt, kf, Cin, Cout_dx) at the dx's own Cout; the padded
    channels' dx and dw are dropped."""
    cin, cout = w.shape[-2:]
    cin_k, cout_k = shapes['dw']
    cout_dx = shapes['dx'][1]
    xk = _pad_last(x, cin_k)
    gyk = _pad_last(gy, cout_k)
    gy_dx = w_dx = None
    if need_dx:
        gy_dx = gyk if cout_dx == cout_k else _pad_last(gy, cout_dx)
        w_dx = F.pad(w, (0, cout_dx - cout, 0, cin_k - cin))
    dx, dw = conv_bwd(xk, gyk, gy_dx, w_dx, need_dx)
    if (cin_k, cout_k) != (cin, cout):
        dw = dw[..., :cin, :cout].contiguous()
        if dx is not None and cin_k != cin:
            dx = dx[..., :cin].contiguous()
    return dx, dw


def _launch_conv_f32(x, w, b):
    """``pbsed_conv2d_same_f32`` on CUDA tensors with a leading member
    axis: x (M, B, T, F, Cin), w (M, kt, kf, Cin, Cout), b (M, Cout) or
    None; one launch for all M, at the channels :func:`_f32_channels`
    gives; a kernel whose halo fits no tile as the f32 sum of its tap
    blocks (:func:`_f32_tap_blocks`), one launch each."""
    build.require_cuda(x, w)
    members, bsz, t, f, cin = x.shape
    kt, kf, _, cout = w.shape[1:]
    blocks = _f32_tap_blocks(f, cin, cout, kt, kf, ('fwd',))
    if blocks != (kt, kf):
        return _conv_by_blocks(lambda xs, wb: _launch_conv_f32(xs, wb, None),
                               x, w, b, *blocks)
    cin_k, cout_k = _f32_pass_shapes(f, cin, cout, kt, kf)['fwd']

    def launch(x, w, b):
        x = _aligned16(x.contiguous())
        w = w.float().contiguous()
        b = None if b is None else b.float().contiguous()
        y = torch.empty((members, bsz, t, f, cout_k), dtype=torch.float32,
                        device=x.device)
        split = _f32_split('fwd', f, cin_k, cout_k, kt, kf, members,
                           x.device)
        build.launch('conv2d_same_f32', 'pbsed_conv2d_same_f32', x.device,
                     x.data_ptr(), w.data_ptr(),
                     None if b is None else b.data_ptr(), y.data_ptr(),
                     split.data_ptr(), members, bsz, t, f, cin_k, cout_k,
                     kt, kf)
        return y

    y = _f32_padded_conv(launch, x, w, b, cin_k, cout_k)
    if _f32_design('fwd', f, cin_k, cout_k, kt, kf)[0] == 'entry':
        build.LAUNCHES['conv2d_same_f32_entry'] += 1
    return y


def conv2d_same_f32(x, w, b):
    """Stride-1 SAME conv (XLA's pads) in float32: ``(B, T, F, Cin)`` f32
    -> ``(B, T, F, Cout)`` f32, f32 sums and an f32 bias, any kernel
    extent and channel counts (``csrc/conv2d_f32.cu``: 3xTF32 on the
    tensor cores, on the entry kernels at Cin < 16, else on wgmma,
    :func:`conv_f32_designs`; no plain TF32).

    Args:
        x: (B, T, F, Cin) float32 activations.
        w: (kt, kf, Cin, Cout) weights (f32).
        b: (Cout,) bias (f32) or None.
    """
    _check_conv(x, w, b, torch.float32, 'conv2d_same_f32')
    if x.device.type == 'cpu':
        return conv2d_same_f32_plain(x, w, b)
    return _launch_conv_f32(x[None], w[None],
                            None if b is None else b[None])[0]


def conv2d_same_f32_members_plain(x, w, b):
    """Plain version of :func:`conv2d_same_f32_members`: each member's
    :func:`conv2d_same_f32_plain`."""
    return torch.stack([conv2d_same_f32_plain(x[m], w[m],
                                              None if b is None else b[m])
                        for m in range(x.shape[0])])


def conv2d_same_f32_members(x, w, b):
    """:func:`conv2d_same_f32` of M stacked members in one launch: x (M,
    B, T, F, Cin) f32, w (M, kt, kf, Cin, Cout), b (M, Cout) or None;
    member m's output is ``conv2d_same_f32(x[m], w[m], b[m])``, bit for
    bit on the card."""
    if x.dim() != 5 or w.dim() != 5:
        raise ValueError(f'expected x (M, B, T, F, Cin) and w (M, kt, kf, '
                         f'Cin, Cout), got {tuple(x.shape)} and '
                         f'{tuple(w.shape)}')
    for name, a in (('w', w), ('b', b)):
        if a is not None and a.shape[0] != x.shape[0]:
            raise ValueError(f'{name} has {a.shape[0]} members, x '
                             f'{x.shape[0]}')
    _check_conv(x[0], w[0], None if b is None else b[0], torch.float32,
                'conv2d_same_f32')
    if x.device.type == 'cpu':
        return conv2d_same_f32_members_plain(x, w, b)
    return _launch_conv_f32(x, w, b)


def conv2d_same_f32_bwd_plain(x, w, gy):
    """Plain backward of :func:`conv2d_same_f32`, TF32 and cuDNN off: dx
    the SAME conv of the cotangent with the flipped, channel-transposed
    weights (the pads mirrored), dw the correlation of x with the
    cotangent; both f32."""
    kt, kf, cin, cout = w.shape
    gf = gy.float().permute(0, 3, 1, 2)
    xf = x.float().permute(0, 3, 1, 2)
    with full_f32(cudnn=False):
        dx = _conv_same(gf, w.float().flip(0, 1).permute(2, 3, 0, 1),
                        flip=True)
        if kt % 2 and kf % 2:
            dw = torch.nn.grad.conv2d_weight(
                xf, (cout, cin, kt, kf), gf,
                padding=((kt - 1) // 2, (kf - 1) // 2))
        else:
            dw = torch.nn.grad.conv2d_weight(
                F.pad(xf, _same_pads(kt, kf)), (cout, cin, kt, kf), gf)
    return (dx.permute(0, 2, 3, 1).contiguous(),
            dw.permute(2, 3, 1, 0).contiguous())


def _launch_conv_f32_bwd(x, w, gy, need_dx):
    """``pbsed_conv2d_same_f32_bwd`` on CUDA tensors: dx (None and no dx
    pass with ``need_dx=False``) and dw at the launch shapes of
    :func:`_f32_pass_shapes`, or, for a kernel whose halo fits no tile,
    from its tap blocks (:func:`_f32_tap_blocks`), one launch each."""
    build.require_cuda(x, w, gy)
    bsz, t, f, cin = x.shape
    kt, kf, _, cout = w.shape
    blocks = _f32_tap_blocks(f, cin, cout, kt, kf,
                             ('dx', 'dw') if need_dx else ('dw',))
    if blocks != (kt, kf):
        return _conv_bwd_by_blocks(
            lambda xs, wb, g: _launch_conv_f32_bwd(xs, wb, g, need_dx), x,
            w, gy, *blocks, need_dx=need_dx)
    shapes = _f32_pass_shapes(f, cin, cout, kt, kf)
    cin_k, cout_k = shapes['dw']
    cout_dx = shapes['dx'][1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count

    def launch(x, gy, gy_dx, w_dx, need_dx):
        x = _aligned16(x.contiguous())
        gy = _aligned16(gy.float().contiguous())
        chunks = build.lib().pbsed_conv2d_f32_dw_chunks(
            bsz, t, f, cin_k, cout_k, kt, kf, sms)
        workspace = torch.empty((chunks, kt * kf * cin_k, cout_k),
                                dtype=torch.float32, device=x.device)
        dw = torch.empty((kt, kf, cin_k, cout_k), dtype=torch.float32,
                         device=x.device)
        dx = w_flip = split = None
        if need_dx:
            gy_dx = gy if cout_dx == cout_k else _aligned16(
                gy_dx.float().contiguous())
            dx = torch.empty_like(x)
            w_flip = w_dx.float().flip(0, 1).transpose(2, 3).contiguous()
            split = _f32_split('dx', f, cin_k, cout_dx, kt, kf, 1, x.device)
        build.launch('conv2d_same_f32_bwd', 'pbsed_conv2d_same_f32_bwd',
                     x.device, x.data_ptr(), gy.data_ptr(),
                     None if dx is None else gy_dx.data_ptr(),
                     None if w_flip is None else w_flip.data_ptr(),
                     None if dx is None else dx.data_ptr(), dw.data_ptr(),
                     workspace.data_ptr(),
                     None if split is None else split.data_ptr(),
                     bsz, t, f, cin_k, cout_k, cout_dx, kt, kf, sms)
        return dx, dw

    dx, dw = _f32_padded_conv_bwd(launch, x, w, gy, shapes, need_dx)
    if 'entry' in [_f32_design(name, f, *shapes[name], kt, kf)[0]
                   for name in (('dx', 'dw') if need_dx else ('dw',))]:
        build.LAUNCHES['conv2d_same_f32_bwd_entry'] += 1
    return dx, dw


def conv2d_same_f32_bwd(x, w, gy, need_dx=True):
    """Backward of :func:`conv2d_same_f32` w.r.t. x and w: dx (B, T, F,
    Cin) and dw (kt, kf, Cin, Cout), both float32; dx is None (no dx pass)
    with ``need_dx=False``. dx runs the forward's GEMM on the cotangent;
    dw's pixel-chunk partials are added in chunk order, so reruns agree in
    every bit. The bias gradient is the sum of gy, left to the caller."""
    _check_conv(x, w, None, torch.float32, 'conv2d_same_f32_bwd')
    want = tuple(x.shape[:3]) + (w.shape[-1],)
    if tuple(gy.shape) != want:
        raise ValueError(f'cotangent shape {tuple(gy.shape)} != {want}')
    if x.device.type == 'cpu':
        dx, dw = conv2d_same_f32_bwd_plain(x, w, gy)
        return (dx if need_dx else None), dw
    return _launch_conv_f32_bwd(x, w, gy, need_dx)


@cache_signature
class Conv2dSameF32(torch.autograd.Function):
    """:func:`conv2d_same_f32` with its backward: dx (only where autograd
    needs it: the recipes' entry layer needs it, since their pre-activation
    norm's learnable scale and shift sit before it; a layer with nothing
    upstream that needs a gradient runs none) and dw from
    :func:`conv2d_same_f32_bwd`, db the sum of the cotangent. Under
    ``torch.func.vmap`` (a stacked ensemble) all members in one launch,
    :func:`conv2d_same_f32_members`."""

    @staticmethod
    def forward(x, w, b):
        return conv2d_same_f32(x, w, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b = inputs
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        return conv2d_same_f32_members(*members_first(info, in_dims,
                                                      (x, w, b))), 0

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        dx, dw = conv2d_same_f32_bwd(x, w, gy,
                                     need_dx=ctx.needs_input_grad[0])
        db = gy.float().sum((0, 1, 2)) if ctx.has_bias else None
        return dx, dw.to(w.dtype), db


def _check_affine(x, scale, shift):
    cin = x.shape[-1]
    for name, a in (('scale', scale), ('shift', shift)):
        if tuple(a.shape) != (cin,):
            raise ValueError(f'{name} shape {tuple(a.shape)} != ({cin},)')
        if not a.is_floating_point():
            raise TypeError(f'{name} must be floating point, got {a.dtype}')
        if a.device != x.device:
            raise ValueError('x, scale and shift must be on one device')


def bnrelu_plain(x, scale, shift):
    """The post-activation buffer ``a = bf16(relu(f32(x * scale +
    shift)))`` with ONE f32 rounding of the affine: XLA contracts the JAX
    package's ``v * sc + sh`` (``pb_sed_tpu/ops/pallas/conv.py:
    _stage_bnrelu``) into a fused multiply-add, and so does the kernel.
    Here the product of a bf16 and an f32 value is exact in float64 and
    the sum is rounded there and then to f32, which equals the fused
    multiply-add but where the float64 sum lands exactly halfway between
    two f32 values."""
    a = x.double() * scale.double() + shift.double()
    return torch.relu(a.float()).to(torch.bfloat16)


def bnrelu_conv2d_same_plain(x, scale, shift, w, b):
    """Plain version: :func:`conv2d_same_plain` of :func:`bnrelu_plain`
    (the conv's zero padding is added after the transform: the SAME halo
    stays 0 whatever the shift)."""
    return conv2d_same_plain(bnrelu_plain(x, scale, shift), w, b)


def bnrelu_conv2d_same(x, scale, shift, w, b):
    """The BN+ReLU-fused SAME conv: ``conv2d_same(bnrelu_plain(x, scale,
    shift), w, b)`` with the transform applied while the kernel stages
    its input, so the post-activation buffer never exists in device
    memory.

    Args:
        x: (B, T, F, Cin) bfloat16 pre-norm activations.
        scale, shift: (Cin,) folded batch norm (f32).
        w: (kt, kf, Cin, Cout) weights (rounded to bf16), any extents and
            Cout.
        b: (Cout,) bias (f32) or None.
    """
    _check_conv(x, w, b)
    _check_affine(x, scale, shift)
    if x.device.type == 'cpu':
        return bnrelu_conv2d_same_plain(x, scale, shift, w, b)
    return _launch_conv('bnrelu_conv2d_same', x[None], w[None],
                        None if b is None else b[None],
                        (scale[None], shift[None]))[0]


def bnrelu_conv2d_same_members_plain(x, scale, shift, w, b):
    """Plain version of :func:`bnrelu_conv2d_same_members`: each member's
    :func:`bnrelu_conv2d_same_plain`."""
    return torch.stack([
        bnrelu_conv2d_same_plain(x[m], scale[m], shift[m], w[m],
                                 None if b is None else b[m])
        for m in range(x.shape[0])])


def bnrelu_conv2d_same_members(x, scale, shift, w, b):
    """:func:`bnrelu_conv2d_same` of M stacked members in one launch:
    x (M, B, T, F, Cin), scale and shift (M, Cin), w (M, kt, kf, Cin,
    Cout), b (M, Cout) or None; member m's output is
    ``bnrelu_conv2d_same(x[m], scale[m], shift[m], w[m], b[m])``, bit for
    bit on the card."""
    _check_members(x, w, b, (scale, shift))
    if x.device.type == 'cpu':
        return bnrelu_conv2d_same_members_plain(x, scale, shift, w, b)
    return _launch_conv('bnrelu_conv2d_same', x, w, b, (scale, shift))


def bnrelu_conv2d_same_bwd_plain(x, scale, shift, w, gy):
    """Plain backward: :func:`conv2d_same_bwd_plain` of the recomputed
    post-activation buffer."""
    return conv2d_same_bwd_plain(bnrelu_plain(x, scale, shift), w, gy)


def bnrelu_conv2d_same_bwd(x, scale, shift, w, gy):
    """Backward of :func:`bnrelu_conv2d_same` w.r.t. the post-activation
    buffer and w.

    Returns: da (B, T, F, Cin) bfloat16, the gradient w.r.t. ``a`` (it
    never reads x), and dw (kt, kf, Cin, Cout) float32 with ``a``
    recomputed from x, scale and shift. The chain through the affine is
    :func:`bnrelu_chain`.
    """
    _check_conv_bwd(x, w, gy)
    _check_affine(x, scale, shift)
    if x.device.type == 'cpu':
        return bnrelu_conv2d_same_bwd_plain(x, scale, shift, w, gy)
    return _launch_conv_bwd('bnrelu_conv2d_same_bwd', x, w, gy,
                            (scale.float().contiguous(),
                             shift.float().contiguous()))


def bnrelu_chain(x, scale, shift, da):
    """dx (bf16), dscale and dshift (f32) from ``da`` through ``a =
    relu(x * scale + shift)``: ``dz = da * 1[x * scale + shift > 0]``,
    ``dx = bf16(dz * scale)``, ``dscale = sum(dz * x)``, ``dshift =
    sum(dz)`` (``pb_sed_tpu/ops/pallas/conv.py:1731-1743``; plain PyTorch
    there and here). The gate's affine is f32 with two roundings: it can
    differ from the forward's only where ``x * scale + shift`` is within
    one f32 rounding of 0."""
    xf = x.float()
    s, t = scale.float(), shift.float()
    dz = torch.where(xf * s + t > 0., da.float(), 0.)
    axes = tuple(range(x.dim() - 1))
    return ((dz * s).to(x.dtype), (dz * xf).sum(axes), dz.sum(axes))


@cache_signature
class BnReluConv2dSame(torch.autograd.Function):
    """:func:`bnrelu_conv2d_same` with its backward
    (``pb_sed_tpu/ops/pallas/conv.py:bnrelu_conv2d_packed``'s custom VJP):
    da and dw from :func:`bnrelu_conv2d_same_bwd`, the chain to x, scale
    and shift from :func:`bnrelu_chain`, db the f32 sum of the bf16
    cotangent. Under ``torch.func.vmap`` all members in one launch,
    :func:`bnrelu_conv2d_same_members`."""

    @staticmethod
    def forward(x, scale, shift, w, b):
        return bnrelu_conv2d_same(x, scale, shift, w, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, shift, w, b = inputs
        ctx.save_for_backward(x, scale, shift, w)
        ctx.has_bias = b is not None

    @staticmethod
    def vmap(info, in_dims, x, scale, shift, w, b):
        return bnrelu_conv2d_same_members(*members_first(
            info, in_dims, (x, scale, shift, w, b))), 0

    @staticmethod
    def backward(ctx, gy):
        x, scale, shift, w = ctx.saved_tensors
        da, dw = bnrelu_conv2d_same_bwd(x, scale, shift, w, gy)
        dx, dscale, dshift = bnrelu_chain(x, scale, shift, da)
        db = gy.float().sum((0, 1, 2)) if ctx.has_bias else None
        return (dx, dscale.to(scale.dtype), dshift.to(shift.dtype),
                dw.to(w.dtype), db)


def _check_pool(x):
    if x.dtype != torch.bfloat16:
        raise TypeError(f'maxpool_freq2 takes bfloat16, got {x.dtype}')
    if x.dim() != 4 or x.shape[2] % 2:
        raise ValueError(f'expected (B, T, F, C) with even F, got '
                         f'{tuple(x.shape)}')


def maxpool_freq2_plain(x):
    """Plain version: max of the even and odd freq rows."""
    return torch.maximum(x[:, :, 0::2], x[:, :, 1::2]).contiguous()


def maxpool_freq2(x):
    """(2, 1) freq max-pool: ``(B, T, F, C)`` -> ``(B, T, F/2, C)``,
    bfloat16 in and out, bit-exact against the plain version."""
    _check_pool(x)
    if x.device.type == 'cpu':
        return maxpool_freq2_plain(x)
    build.require_cuda(x)
    bsz, t, f, c = x.shape
    x = x.contiguous()
    y = torch.empty((bsz, t, f // 2, c), dtype=x.dtype, device=x.device)
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError('maxpool_freq2 needs 16-byte aligned buffers')
    build.launch('maxpool_freq2', 'pbsed_maxpool_freq2', x.device,
                 x.data_ptr(), y.data_ptr(), bsz * t * (f // 2), c)
    return y


def maxpool_freq2_bwd_plain(x, gy):
    """Plain backward: the cotangent (in bf16) goes to the row that won,
    ``keep = f32(even) >= f32(odd)``; ties and a NaN in either row go to
    the row the compare picks (NaN -> the odd row), as the TPU kernel
    does (``pb_sed_tpu/ops/pallas/conv.py:1773-1787``)."""
    xf = x.float()
    keep = xf[:, :, 0::2] >= xf[:, :, 1::2]
    g = gy.to(x.dtype)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    dx = torch.stack([torch.where(keep, g, zero), torch.where(keep, zero, g)],
                     dim=3)
    return dx.reshape(x.shape)


def maxpool_freq2_bwd(x, gy):
    """Backward of :func:`maxpool_freq2`: ``(B, T, F, C)`` input and
    ``(B, T, F/2, C)`` cotangent -> ``(B, T, F, C)`` bf16, bit-exact
    against the plain version."""
    _check_pool(x)
    want = (x.shape[0], x.shape[1], x.shape[2] // 2, x.shape[3])
    if tuple(gy.shape) != want:
        raise ValueError(f'cotangent shape {tuple(gy.shape)} != {want}')
    if x.device.type == 'cpu':
        return maxpool_freq2_bwd_plain(x, gy)
    build.require_cuda(x, gy)
    bsz, t, f, c = x.shape
    x = x.contiguous()
    gy = gy.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    if any(a.data_ptr() % 16 for a in (x, gy, dx)):
        raise ValueError('maxpool_freq2_bwd needs 16-byte aligned buffers')
    build.launch('maxpool_freq2_bwd', 'pbsed_maxpool_freq2_bwd', x.device,
                 x.data_ptr(), gy.data_ptr(), dx.data_ptr(),
                 bsz * t * (f // 2), c)
    return dx


def _on_clips(fn, x, dim, *args):
    """``fn`` of a vmapped ``(B, T, F, C)`` argument (batched along
    ``dim``, or not at all) with the members folded into the clips: one
    launch over ``M * B`` clips."""
    if dim is None:
        return fn(x, *args), None
    x = x.movedim(dim, 0)
    y = fn(x.reshape(-1, *x.shape[2:]), *args)
    return y.reshape(*x.shape[:2], *y.shape[1:]), 0


@cache_signature
class MaxPoolFreq2(torch.autograd.Function):
    """:func:`maxpool_freq2` with its backward
    (:func:`maxpool_freq2_bwd`: ties to the first row, not the even split
    that autograd of ``torch.maximum`` would give). Under
    ``torch.func.vmap`` one launch over the members' clips."""

    @staticmethod
    def forward(x):
        return maxpool_freq2(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def vmap(info, in_dims, x):
        return _on_clips(maxpool_freq2, x, in_dims[0])

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        return maxpool_freq2_bwd(x, gy)


def _windows(x, pt, pf):
    """The elements of every (pt, pf) window of ``x`` (B, T, F, C), VALID
    (floor in both axes): ``pt * pf`` strided (B, T // pt, F // pf, C)
    views in (t, f) order."""
    to, fo = x.shape[1] // pt, x.shape[2] // pf
    return [x[:, dt:to * pt:pt, df:fo * pf:pf]
            for dt in range(pt) for df in range(pf)]


def _check_window(name, x, pt, pf):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'{name} takes bfloat16 or float32, got {x.dtype}')
    if x.dim() != 4:
        raise ValueError(f'{name}: expected (B, T, F, C), got '
                         f'{tuple(x.shape)}')
    if pt < 1 or pf < 1:
        raise ValueError(f'{name}: window ({pt}, {pf})')


def maxpool2d_plain(x, pt, pf):
    """Plain version: ``torch.maximum`` folded over each window in (t, f)
    order."""
    views = _windows(x, pt, pf)
    y = views[0]
    for v in views[1:]:
        y = torch.maximum(y, v)
    return y.contiguous()


def maxpool2d(x, pt, pf):
    """Max pool of (pt, pf) windows over (time, freq) with stride the
    window, VALID: ``(B, T, F, C)`` -> ``(B, T // pt, F // pf, C)``, bf16
    or f32 in and out, bit-exact against the plain version (the JAX
    package's ``nn.max_pool``)."""
    pt, pf = int(pt), int(pf)
    _check_window('maxpool2d', x, pt, pf)
    if x.device.type == 'cpu':
        return maxpool2d_plain(x, pt, pf)
    build.require_cuda(x)
    bsz, t, f, c = x.shape
    x = x.contiguous()
    y = torch.empty((bsz, t // pt, f // pf, c), dtype=x.dtype,
                    device=x.device)
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError('maxpool2d needs 16-byte aligned buffers')
    build.launch('maxpool2d', 'pbsed_maxpool2d', x.device, x.data_ptr(),
                 int(x.dtype == torch.float32), y.data_ptr(), bsz, t, f, c,
                 pt, pf)
    return y


def maxpool2d_bwd_plain(x, gy, pt, pf):
    """Plain backward: each window's cotangent (in x's type) goes to the
    element that XLA's ``>=`` select keeps, walking the window in (t, f)
    order (ties to the first; the kept element gives way to any later one
    it is not ``>=``, so a NaN gives way to the next); the other elements
    and the rows and columns past the last whole window get zero."""
    views = [v.float() for v in _windows(x, pt, pf)]
    best = views[0]
    sel = torch.zeros(best.shape, dtype=torch.int64, device=x.device)
    for k, v in enumerate(views[1:], 1):
        take = ~(best >= v)
        best = torch.where(take, v, best)
        sel = torch.where(take, k, sel)
    g = gy.to(x.dtype)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    dx = torch.zeros_like(x)
    to, fo = g.shape[1], g.shape[2]
    for k in range(pt * pf):
        dt, df = divmod(k, pf)
        dx[:, dt:to * pt:pt, df:fo * pf:pf] = torch.where(sel == k, g, zero)
    return dx


def maxpool2d_bwd(x, gy, pt, pf):
    """Backward of :func:`maxpool2d`: ``(B, T, F, C)`` input and
    ``(B, T // pt, F // pf, C)`` cotangent -> ``(B, T, F, C)`` in x's type,
    bit-exact against the plain version."""
    pt, pf = int(pt), int(pf)
    _check_window('maxpool2d_bwd', x, pt, pf)
    want = (x.shape[0], x.shape[1] // pt, x.shape[2] // pf, x.shape[3])
    if tuple(gy.shape) != want:
        raise ValueError(f'cotangent shape {tuple(gy.shape)} != {want}')
    if x.device.type == 'cpu':
        return maxpool2d_bwd_plain(x, gy, pt, pf)
    build.require_cuda(x, gy)
    bsz, t, f, c = x.shape
    x = x.contiguous()
    gy = gy.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    if any(a.data_ptr() % 16 for a in (x, gy, dx)):
        raise ValueError('maxpool2d_bwd needs 16-byte aligned buffers')
    build.launch('maxpool2d_bwd', 'pbsed_maxpool2d_bwd', x.device,
                 x.data_ptr(), gy.data_ptr(), dx.data_ptr(),
                 int(x.dtype == torch.float32), bsz, t, f, c, pt, pf)
    return dx


@cache_signature
class MaxPool2d(torch.autograd.Function):
    """:func:`maxpool2d` with its backward (:func:`maxpool2d_bwd`: XLA's
    tie rule, not the even split that autograd of ``amax`` would give):
    the pools other than (2, 1) on an even F (``pb_sed_tpu/ops/cnn.py:
    _pool2d``, and ``CNN1d``'s time pools with F = 1). Under
    ``torch.func.vmap`` one launch over the members' clips."""

    @staticmethod
    def forward(x, pt, pf):
        return maxpool2d(x, pt, pf)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.window = inputs[1:]

    @staticmethod
    def vmap(info, in_dims, x, pt, pf):
        return _on_clips(maxpool2d, x, in_dims[0], pt, pf)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        return maxpool2d_bwd(x, gy, *ctx.window), None, None


def _check_avg(x, cout):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'avgpool_freq2 takes bfloat16 or float32, got '
                        f'{x.dtype}')
    if x.dim() != 4 or x.shape[2] % 2:
        raise ValueError(f'expected (B, T, F, C) with even F, got '
                         f'{tuple(x.shape)}')
    if cout < x.shape[3]:
        raise ValueError(f'cannot pad {x.shape[3]} channels to {cout}')


def avgpool_freq2_plain(x, cout=None):
    """Plain version: the f32 mean of the even and odd freq rows, zero
    channels appended up to ``cout``."""
    c = x.shape[3]
    y = (x[:, :, 0::2].float() + x[:, :, 1::2].float()) * .5
    return F.pad(y, (0, (cout or c) - c)).contiguous()


def avgpool_freq2(x, cout=None):
    """(2, 1) freq average pool of a residual: ``(B, T, F, C)`` bf16 or
    f32 -> ``(B, T, F/2, cout)`` f32 (``cout`` defaults to C; channels
    from C on are zeros), bit-exact against the plain version."""
    cout = x.shape[3] if cout is None else int(cout)
    _check_avg(x, cout)
    if x.device.type == 'cpu':
        return avgpool_freq2_plain(x, cout)
    build.require_cuda(x)
    bsz, t, f, c = x.shape
    x = x.contiguous()
    y = torch.empty((bsz, t, f // 2, cout), dtype=torch.float32,
                    device=x.device)
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError('avgpool_freq2 needs 16-byte aligned buffers')
    build.launch('avgpool_freq2', 'pbsed_avgpool_freq2', x.device,
                 x.data_ptr(), int(x.dtype == torch.float32), y.data_ptr(),
                 bsz * t * (f // 2), c, cout)
    return y


def avgpool_freq2_bwd_plain(gy, c, dtype):
    """Plain backward: half the (f32) cotangent of the first ``c``
    channels to both rows, cast to ``dtype`` (the Pallas kernel's
    ``(gy * 0.5).astype(dx.dtype)``)."""
    g = (gy[..., :c].float() * .5).to(dtype)
    return torch.stack([g, g], dim=3).reshape(
        gy.shape[0], gy.shape[1], 2 * gy.shape[2], c)


def avgpool_freq2_bwd(gy, c, dtype):
    """Backward of :func:`avgpool_freq2` for an input of ``c`` channels
    and type ``dtype``: ``(B, T, F/2, cout)`` cotangent -> ``(B, T, F, c)``
    in ``dtype``, bit-exact against the plain version."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'avgpool_freq2_bwd gives bfloat16 or float32, got '
                        f'{dtype}')
    if gy.dim() != 4 or gy.shape[3] < c:
        raise ValueError(f'cotangent {tuple(gy.shape)} for {c} channels')
    if gy.device.type == 'cpu':
        return avgpool_freq2_bwd_plain(gy, c, dtype)
    build.require_cuda(gy)
    bsz, t, fo, cout = gy.shape
    gy = gy.float().contiguous()
    dx = torch.empty((bsz, t, 2 * fo, c), dtype=dtype, device=gy.device)
    if gy.data_ptr() % 16 or dx.data_ptr() % 16:
        raise ValueError('avgpool_freq2_bwd needs 16-byte aligned buffers')
    build.launch('avgpool_freq2_bwd', 'pbsed_avgpool_freq2_bwd', gy.device,
                 gy.data_ptr(), dx.data_ptr(), int(dtype == torch.float32),
                 bsz * t * fo, c, cout)
    return dx


@cache_signature
class AvgPoolFreq2(torch.autograd.Function):
    """:func:`avgpool_freq2` (with the channel pad to ``cout``) and its
    backward :func:`avgpool_freq2_bwd`: a residual matched across a
    (2, 1) pool (``pb_sed_tpu/ops/cnn.py:_match_residual_packed``). Under
    ``torch.func.vmap`` one launch over the members' clips."""

    @staticmethod
    def forward(x, cout):
        return avgpool_freq2(x, cout)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x = inputs[0]
        ctx.c, ctx.dtype = x.shape[3], x.dtype

    @staticmethod
    def vmap(info, in_dims, x, cout):
        return _on_clips(avgpool_freq2, x, in_dims[0], cout)

    @staticmethod
    def backward(ctx, gy):
        return avgpool_freq2_bwd(gy, ctx.c, ctx.dtype), None


def _reciprocal(n):
    """``1 / n`` rounded to f32, as a 0-d f32 tensor (a product with it is
    the same on the CPU and the card)."""
    return torch.tensor(1., dtype=torch.float32) / n


def avgpool2d_plain(x, st, sf, cout=None):
    """Plain version: each (st, sf) window's elements added in f32 one
    after the other in (t, f) order from 0, times the f32 reciprocal of
    ``st * sf`` (the JAX package divides: one f32 rounding apart), zero
    channels appended up to ``cout``."""
    c = x.shape[3]
    views = _windows(x, st, sf)
    acc = torch.zeros(views[0].shape, dtype=torch.float32, device=x.device)
    for v in views:
        acc = acc + v.float()
    y = acc * _reciprocal(st * sf)
    return F.pad(y, (0, (cout or c) - c)).contiguous()


def avgpool2d(x, st, sf, cout=None):
    """Average pool of (st, sf) windows over (time, freq) with stride the
    window, VALID, of a residual: ``(B, T, F, C)`` bf16 or f32 -> ``(B,
    T // st, F // sf, cout)`` f32 (``cout`` defaults to C; channels from C
    on are zeros), bit-exact against the plain version: the JAX package's
    ``_match_residual`` on its unpacked path (one ``nn.avg_pool``, then the
    channel pad)."""
    st, sf = int(st), int(sf)
    cout = x.shape[3] if cout is None else int(cout)
    _check_window('avgpool2d', x, st, sf)
    if cout < x.shape[3]:
        raise ValueError(f'cannot pad {x.shape[3]} channels to {cout}')
    if x.device.type == 'cpu':
        return avgpool2d_plain(x, st, sf, cout)
    build.require_cuda(x)
    bsz, t, f, c = x.shape
    x = x.contiguous()
    y = torch.empty((bsz, t // st, f // sf, cout), dtype=torch.float32,
                    device=x.device)
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError('avgpool2d needs 16-byte aligned buffers')
    build.launch('avgpool2d', 'pbsed_avgpool2d', x.device, x.data_ptr(),
                 int(x.dtype == torch.float32), y.data_ptr(), bsz, t, f, c,
                 cout, st, sf)
    return y


def avgpool2d_bwd_plain(gy, st, sf, shape, dtype):
    """Plain backward: the f32 cotangent of the first C channels times the
    f32 reciprocal of ``st * sf``, cast to ``dtype``, to every element of
    its window; zero past the last whole window. ``shape`` is the input's
    (B, T, F, C)."""
    bsz, t, f, c = shape
    to, fo = gy.shape[1], gy.shape[2]
    g = (gy[..., :c].float() * _reciprocal(st * sf)).to(dtype)
    dx = torch.zeros((bsz, t, f, c), dtype=dtype, device=gy.device)
    dx[:, :to * st, :fo * sf] = g.repeat_interleave(st, 1).repeat_interleave(
        sf, 2)
    return dx


def avgpool2d_bwd(gy, st, sf, shape, dtype):
    """Backward of :func:`avgpool2d` for an input of ``shape`` (B, T, F, C)
    and type ``dtype``: ``(B, T // st, F // sf, cout)`` f32 cotangent ->
    ``shape`` in ``dtype``, bit-exact against the plain version."""
    st, sf = int(st), int(sf)
    bsz, t, f, c = (int(n) for n in shape)
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'avgpool2d_bwd gives bfloat16 or float32, got '
                        f'{dtype}')
    if (gy.dim() != 4 or tuple(gy.shape[:3]) != (bsz, t // st, f // sf)
            or gy.shape[3] < c):
        raise ValueError(f'cotangent {tuple(gy.shape)} for an input of '
                         f'{tuple(shape)} and window ({st}, {sf})')
    if gy.device.type == 'cpu':
        return avgpool2d_bwd_plain(gy, st, sf, (bsz, t, f, c), dtype)
    build.require_cuda(gy)
    cout = gy.shape[3]
    gy = gy.float().contiguous()
    dx = torch.empty((bsz, t, f, c), dtype=dtype, device=gy.device)
    if gy.data_ptr() % 16 or dx.data_ptr() % 16:
        raise ValueError('avgpool2d_bwd needs 16-byte aligned buffers')
    build.launch('avgpool2d_bwd', 'pbsed_avgpool2d_bwd', gy.device,
                 gy.data_ptr(), dx.data_ptr(), int(dtype == torch.float32),
                 bsz, t, f, c, cout, st, sf)
    return dx


@cache_signature
class AvgPool2d(torch.autograd.Function):
    """:func:`avgpool2d` (with the channel pad to ``cout``) and its
    backward :func:`avgpool2d_bwd`: a residual matched across a time pool,
    a pool other than (2, 1) or an odd F (``pb_sed_tpu/ops/cnn.py:
    _match_residual``). Under ``torch.func.vmap`` one launch over the
    members' clips."""

    @staticmethod
    def forward(x, st, sf, cout):
        return avgpool2d(x, st, sf, cout)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.st, ctx.sf, _ = inputs
        ctx.shape, ctx.dtype = tuple(x.shape), x.dtype

    @staticmethod
    def vmap(info, in_dims, x, st, sf, cout):
        return _on_clips(avgpool2d, x, in_dims[0], st, sf, cout)

    @staticmethod
    def backward(ctx, gy):
        return (avgpool2d_bwd(gy, ctx.st, ctx.sf, ctx.shape, ctx.dtype),
                None, None, None)
