"""2-D conv tower kernels: the odd-kernel SAME conv (3x3 and 1x1), the
same conv with batch norm and ReLU folded into its input load (the
``fuse_bn`` tower), the (2, 1) freq max-pool and the (2, 1) freq average
pool that matches a residual across a pool, forward and backward, each as
a hand-written CUDA kernel with its plain PyTorch version beside it, and
the autograd Functions that tie each forward to its backward
(``Conv2dSame``, ``BnReluConv2dSame``, ``MaxPoolFreq2``,
``AvgPoolFreq2``).

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
import math

import torch
import torch.nn.functional as F

from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.functions import (cache_signature,
                                                    members_first)


def _check_conv(x, w, b):
    if x.dtype != torch.bfloat16:
        raise TypeError(f'conv2d_same takes a bfloat16 input, got {x.dtype}')
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f'expected x (B, T, F, Cin) and w (kt, kf, Cin, '
                         f'Cout), got {tuple(x.shape)} and {tuple(w.shape)}')
    kt, kf, cin, cout = w.shape
    if kt % 2 == 0 or kf % 2 == 0:
        raise ValueError(f'odd kernel extents only, got {kt}x{kf}')
    if x.shape[-1] != cin:
        raise ValueError(f'input has {x.shape[-1]} channels, kernel {cin}')
    if cout % 16:
        raise ValueError(f'Cout must be a multiple of 16, got {cout}')
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f'bias shape {tuple(b.shape)} != ({cout},)')
    if not w.is_floating_point() or (b is not None
                                     and not b.is_floating_point()):
        raise TypeError('weights and bias must be floating point')
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError('x, w and b must be on one device')


def conv2d_same_plain(x, w, b):
    """Plain version: bf16-rounded operands in f32, f32 bias, one final
    rounding to bf16 (the order of the TPU kernel's epilogue)."""
    kt, kf, _, cout = w.shape
    xf = x.float().permute(0, 3, 1, 2)                       # (B, Cin, T, F)
    wf = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)    # OIHW
    y = F.conv2d(xf, wf, padding=((kt - 1) // 2, (kf - 1) // 2))
    if b is not None:
        y = y + b.float()[None, :, None, None]
    return y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def conv2d_same(x, w, b):
    """Stride-1 SAME conv, odd kernel: ``(B, T, F, Cin)`` bf16 ->
    ``(B, T, F, Cout)`` bf16 with f32 accumulation and f32 bias.

    Args:
        x: (B, T, F, Cin) bfloat16 activations (any Cin >= 1).
        w: (kt, kf, Cin, Cout) weights (rounded to bf16), Cout % 16 == 0.
        b: (Cout,) bias (f32) or None.
    """
    _check_conv(x, w, b)
    if x.device.type == 'cpu':
        return conv2d_same_plain(x, w, b)
    return _launch_conv('conv2d_same', x[None], w[None],
                        None if b is None else b[None])[0]


def _launch_conv(counter, x, w, b, affine=()):
    """Launch ``pbsed_<counter>`` on CUDA tensors with a leading member
    axis (x (M, B, T, F, Cin), w (M, kt, kf, Cin, Cout), b (M, Cout) or
    None): the SAME conv of all M members in one launch, with ``affine =
    (scale, shift)``, each (M, Cin), for the BN+ReLU-fused one."""
    build.require_cuda(x, w, *affine)
    members, bsz, t, f, cin = x.shape
    kt, kf, _, cout = w.shape[1:]
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
    return y


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
    return _launch_conv('conv2d_same', x, w, b)


def _check_conv_bwd(x, w, gy):
    _check_conv(x, w, None)
    want = tuple(x.shape[:3]) + (w.shape[-1],)
    if tuple(gy.shape) != want:
        raise ValueError(f'cotangent shape {tuple(gy.shape)} != {want}')
    if gy.device != x.device:
        raise ValueError('x and gy must be on one device')


def conv2d_same_bwd_plain(x, w, gy):
    """Plain backward: dx is the SAME conv of the cotangent with the
    spatially flipped, channel-transposed bf16 weights in f32, rounded
    once to bf16 (no bias); dw the f32 correlation of the bf16 input with
    the bf16-rounded cotangent."""
    kt, kf, cin, cout = w.shape
    pad = ((kt - 1) // 2, (kf - 1) // 2)
    gf = gy.to(torch.bfloat16).float().permute(0, 3, 1, 2)  # (B, Cout, T, F)
    w_flip = w.to(torch.bfloat16).float().flip(0, 1)        # (kt, kf, Ci, Co)
    dx = F.conv2d(gf, w_flip.permute(2, 3, 0, 1), padding=pad)
    dw = torch.nn.grad.conv2d_weight(
        x.float().permute(0, 3, 1, 2), (cout, cin, kt, kf), gf, padding=pad)
    return (dx.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous(),
            dw.permute(2, 3, 1, 0).contiguous())


def _dw_chunks(bsz, t, f, cin, cout, kt, kf, device):
    """Pixel chunks of the dw pass (the workspace's first dimension), as
    the C side tiles it (``csrc/conv2d_wgmma.cuh:conv2d_dw_chunks``): one
    wave of blocks on the card's SMs for the wgmma kernel, about four
    blocks per SM for the narrow one."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return build.lib().pbsed_conv2d_dw_chunks(bsz, t, f, cin, cout, kt, kf,
                                              sms)


def conv_designs(f, cin, cout, kt=3, kf=3):
    """Which kernels the conv of a (F, Cin -> Cout, kt x kf) layer runs on
    the card, as the C entry points decide: for each pass ``'fwd'``,
    ``'dx'`` and ``'dw'`` a dict of ``design`` ('wgmma',
    ``csrc/conv2d_wgmma.cuh``, or 'narrow'), ``stages`` (the depth of the
    wgmma kernel's activation ring, 0 for the narrow one) and ``smem``
    (its dynamic shared memory in bytes)."""
    lib = build.lib()
    queries = {'fwd': (lib.pbsed_conv2d_design, cin, cout),
               'dx': (lib.pbsed_conv2d_design, cout, cin),
               'dw': (lib.pbsed_conv2d_dw_design, cin, cout)}
    designs = {}
    for name, (query, c_in, c_out) in queries.items():
        stages, smem = ctypes.c_int(), ctypes.c_int()
        wgmma = query(f, c_in, c_out, kt, kf, ctypes.byref(stages),
                      ctypes.byref(smem))
        designs[name] = {'design': 'wgmma' if wgmma else 'narrow',
                         'stages': stages.value, 'smem': smem.value}
    return designs


def conv2d_same_bwd(x, w, gy):
    """Backward of :func:`conv2d_same` w.r.t. x and w.

    Args:
        x: (B, T, F, Cin) bfloat16 forward input.
        w: (kt, kf, Cin, Cout) weights (rounded to bf16).
        gy: (B, T, F, Cout) cotangent of the bf16 output (rounded to
            bf16, as the output's type).

    Returns: dx (B, T, F, Cin) bfloat16 and dw (kt, kf, Cin, Cout)
    float32. The bias gradient is the f32 sum of gy, left to the caller.
    """
    _check_conv_bwd(x, w, gy)
    if x.device.type == 'cpu':
        return conv2d_same_bwd_plain(x, w, gy)
    return _launch_conv_bwd('conv2d_same_bwd', x, w, gy)


def _launch_conv_bwd(counter, x, w, gy, affine=()):
    """Launch ``pbsed_<counter>`` on CUDA tensors: dx (or da) and dw of
    the SAME conv, with ``affine = (scale, shift)`` f32 pointers after
    the flipped weights for the BN+ReLU-fused one."""
    build.require_cuda(x, w, gy, *affine)
    bsz, t, f, cin = x.shape
    kt, kf, _, cout = w.shape
    x = x.contiguous()
    gy = gy.to(torch.bfloat16).contiguous()
    w_flip = w.to(torch.bfloat16).flip(0, 1).transpose(2, 3).contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty((kt, kf, cin, cout), dtype=torch.float32,
                     device=x.device)
    chunks = _dw_chunks(bsz, t, f, cin, cout, kt, kf, x.device)
    workspace = torch.empty((chunks, kt * kf, 16 * math.ceil(cin / 16), cout),
                            dtype=torch.float32, device=x.device)
    if any(a.data_ptr() % 16 for a in (x, gy, w_flip, dx, workspace,
                                       *affine)):
        raise ValueError(f'{counter} needs 16-byte aligned buffers')
    build.launch(counter, f'pbsed_{counter}', x.device,
                 x.data_ptr(), gy.data_ptr(), w_flip.data_ptr(),
                 *(a.data_ptr() for a in affine), dx.data_ptr(),
                 dw.data_ptr(), workspace.data_ptr(),
                 bsz, t, f, cin, cout, kt, kf, chunks)
    return dx, dw


@cache_signature
class Conv2dSame(torch.autograd.Function):
    """:func:`conv2d_same` with its backward: dx and dw from
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
        dx, dw = conv2d_same_bwd(x, w, gy)
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
        w: (kt, kf, Cin, Cout) weights (rounded to bf16), Cout % 16 == 0.
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
