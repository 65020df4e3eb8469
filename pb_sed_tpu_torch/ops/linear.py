"""A bf16 matmul whose f32 bias lies inside its one rounding (and its
full-f32 counterpart, :class:`F32Linear`):
``y = bf16(x @ w + b)`` with bf16 operands and f32 accumulation, the
arithmetic of the JAX package's ``jnp.dot(x_bf16, w_bf16,
preferred_element_type=f32) + b`` rounded to bf16. The GRU input
projections (``ops/rnn.py:GRULayer.project``) and the 1x1 convs of the
2-D tower (``ops/cnn.py:Conv2d``, the JAX package's packed 1x1 einsum,
``pb_sed_tpu/ops/cnn.py:81-99``) run through it.
"""
import torch

from pb_sed_tpu_torch.ops.kernels.functions import (cache_signature,
                                                    full_f32, members_first)


def split_bias(b):
    """An f32 vector as three bf16 terms ``hi, mid, lo`` whose f32 sum is
    ``b`` (each term takes the next 8 significant bits)."""
    b = b.float()
    hi = b.to(torch.bfloat16)
    mid = (b - hi.float()).to(torch.bfloat16)
    lo = (b - hi.float() - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _augmented(x, w, b):
    """The operands of :class:`Bf16Linear`'s one matmul, for x (..., N, F),
    w (..., F, M) and b (..., M) with any (broadcastable) leading axes:
    x with three columns of ones (K padded to a multiple of 8 with zeros),
    w with the three bf16 rows of :func:`split_bias`, both bf16."""
    n, f = x.shape[-2:]
    k = -(-(f + 3) // 8) * 8
    xa = torch.empty((*x.shape[:-2], n, k), dtype=torch.bfloat16,
                     device=x.device)
    xa[..., :f] = x
    ones = torch.zeros(k - f, dtype=torch.bfloat16, device=x.device)
    ones[:3] = 1.
    xa[..., f:] = ones
    wa = torch.zeros((*w.shape[:-2], k, w.shape[-1]), dtype=torch.bfloat16,
                     device=w.device)
    wa[..., :f, :] = w
    wa[..., f:f + 3, :] = torch.stack(split_bias(b), dim=-2)
    return xa, wa


@cache_signature
class Bf16Linear(torch.autograd.Function):
    """``Bf16Linear.apply(x, w, b)``: x (N, K), w (K, M), b (M,)
    -> (N, M) bf16, rounded once.

    One bf16 matmul (cuBLAS on the card) with the bias folded into the
    contraction: x gets three columns of ones (K padded to a multiple of
    8 with zeros) and w the three bf16 rows :func:`split_bias` gives, so
    the result is written once, in bf16, and no f32 ``(N, M)`` buffer
    exists. The augmented input is the bf16 copy of x that the matmul
    needs anyway. Under ``torch.func.vmap`` (a stacked ensemble) it is
    one batched bf16 matmul over the members.

    Backward: ``dx = bf16(g @ w^T)`` and ``dw = bf16(x^T @ g)`` (bf16
    matmuls with f32 accumulation), ``db`` the f32 sum of the cotangent
    over the rows. That is the JAX package's autodiff of its bf16-operand
    dot: the transpose rule rounds each operand's cotangent to the
    operand's dtype, and the weight enters the dot cast to bf16. (Its CPU
    tests run the 1x1 einsum on f32 operands, where ``dw`` stays f32.)"""

    @staticmethod
    def forward(x, w, b):
        xa, wa = _augmented(x, w, b)
        return xa @ wa

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b = inputs
        ctx.save_for_backward(x, w)
        ctx.dtypes = (x.dtype, w.dtype, b.dtype)

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        # a shared x (in_dim None) broadcasts against the members' weights
        if in_dims[0] is not None:
            x = x.movedim(in_dims[0], 0)
        w, b = members_first(info, in_dims[1:], (w, b))
        xa, wa = _augmented(x, w, b)
        return xa @ wa, 0

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x_dtype, w_dtype, b_dtype = ctx.dtypes
        g16 = g.to(torch.bfloat16)
        dx = g16 @ w.to(torch.bfloat16).t()
        # the bf16 x the matmul read (the augmented input's first columns)
        dw = x.to(torch.bfloat16).t() @ g16
        return (dx.to(x_dtype), dw.to(w_dtype),
                g.float().sum(0).to(b_dtype))


@cache_signature
class F32Linear(torch.autograd.Function):
    """``F32Linear.apply(x, w, b)``: x (N, K), w (K, M), b (M,) -> (N, M)
    f32, ``x @ w + b`` with f32 operands and TF32 off in the forward and
    the backward (:func:`full_f32`): the 1x1 convs of a
    ``compute_dtype='float32'`` 2-D tower and the f32 1-D tower, which the
    JAX package computes with f32 ``lax.conv_general_dilated`` /
    ``nn.Conv(dtype=float32)`` outside any kernel (cuBLAS here). Backward:
    ``dx = g @ w^T``, ``dw = x^T @ g``, ``db`` the sum of g over the rows.
    Under ``torch.func.vmap`` the generated rule batches the matmuls."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, b):
        with full_f32():
            y = x.float() @ w.float()
        return y + b.float()

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b = inputs
        ctx.save_for_backward(x, w)
        ctx.dtypes = (x.dtype, w.dtype, b.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x_dtype, w_dtype, b_dtype = ctx.dtypes
        g = g.float()
        with full_f32():
            dx = g @ w.float().t()
            dw = x.float().t() @ g
        return dx.to(x_dtype), dw.to(w_dtype), g.sum(0).to(b_dtype)
