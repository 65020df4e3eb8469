"""2-D conv tower kernels: the 3x3-class SAME conv and the (2, 1) freq
max-pool, each as a hand-written CUDA kernel with its plain PyTorch
version beside it.

Both work on the channels-last ``(B, T, F, C)`` layout of the tower and
keep the JAX package's parameter layout (conv kernel HWIO
``(kt, kf, Cin, Cout)``). On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches the kernel (``csrc/conv2d.cu``,
``csrc/maxpool.cu``) or raises.
"""
import torch
import torch.nn.functional as F

from pb_sed_tpu_torch.ops.kernels import build


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
    build.require_cuda(x)
    bsz, t, f, cin = x.shape
    kt, kf, _, cout = w.shape
    x = x.contiguous()
    w16 = w.to(torch.bfloat16).contiguous()
    b32 = (torch.zeros(cout, device=x.device) if b is None
           else b.float().contiguous())
    y = torch.empty((bsz, t, f, cout), dtype=torch.bfloat16, device=x.device)
    if x.data_ptr() % 16 or w16.data_ptr() % 16:
        raise ValueError('conv2d_same needs 16-byte aligned buffers')
    build.launch('conv2d_same', 'pbsed_conv2d_same', x.device,
                 x.data_ptr(), w16.data_ptr(), b32.data_ptr(), y.data_ptr(),
                 bsz, t, f, cin, cout, kt, kf)
    return y


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
