"""CNN towers: masked batch norm, the 2-D tower on the conv/pool kernels,
the 1-D tower, and the hybrid ``CNN`` (2-D -> flatten freq -> 1-D).

Counterpart of ``pb_sed_tpu/ops/cnn.py`` with its layouts ((B, T, F, C)
and (B, T, C)), parameter layouts (conv kernels HWIO (kt, kf, Cin, Cout)
/ (k, Cin, Cout)) and state names (``conv_{i}``, ``norm_{i}`` with
``scale``/``shift`` and ``mean``/``var``/``initialized``). The 2-D tower
follows the rounding points of the JAX package's packed kernel tower
(``pb_sed_tpu/ops/cnn.py:_packed_forward``): BN and activation in f32,
activations stored in bf16 between layers, every conv (3x3 and 1x1) in
bf16 with f32 accumulation and f32 bias rounded once, the pool on bf16;
both run as autograd Functions whose backward is a kernel too
(``ops/kernels/conv.py:Conv2dSame``, ``MaxPoolFreq2``), but for the 1x1
convs: one bf16 matmul each (``ops/linear.py:Bf16Linear``), as the JAX
package computes them outside its kernels. With ``fuse_bn`` the layers
the JAX package fuses (:meth:`CNN2d.fused_layers`) fold their batch norm
into ``(scale, shift)`` (``MaskedBatchNorm(fold=True)``) and run
``BnReluConv2dSame``: the normalized buffer never exists. Residual skips
(the deep recipe) follow the same tower: a pending residual is matched
to the use site (row pairs averaged in f32 once per crossed (2, 1) pool,
``AvgPoolFreq2``, grown channels zero-padded), added in f32 to the bf16
conv output and rounded once; the residual is saved after that add and
before the pool. In the 1-D tower the adds stay in f32. The
``nn.Module.training`` flag selects batch statistics over the valid
frames (``seq_len``) and the running-stat update.

Every tower the JAX package takes is taken: any kernel extent (even
ones with XLA's SAME pads) and any channel count (``Conv2dSame`` pads what its kernel does
not take, ``ops/kernels/conv.py:_kernel_weights``); any max pool,
``(freq, time)`` or a scalar, VALID (floor in both axes): (2, 1) on an
even F on the stream kernel (``MaxPoolFreq2``), every other window on
``MaxPool2d``, the 1-D tower's time pools on its f32 values; a time
pool makes ``seq_len`` ``ceil(seq_len / pt)`` while T becomes floor(T /
pt), as in JAX. A residual that crosses only (2, 1) pools on even F
averages row pairs as above; one that crosses any other pool is matched
as the JAX package's unpacked path matches it, by ONE average pool of
window ``(T_res // T, F_res // F)`` (``AvgPool2d``) with the channel pad.
``norm='batch'`` builds ``norm_{i}``; any other value builds no norm and
no variables, as in JAX. ``activation_fn`` is any name of
``flax.linen`` that keeps the shape (:func:`_act`).

``compute_dtype='float32'`` (or None, as in JAX) follows the JAX
package's unpacked XLA path in f32 (``pb_sed_tpu/ops/cnn.py:113-119,
517-530, 713-715``): every conv with f32 operands, f32 sums and an f32
bias (the f32 conv kernel ``Conv2dSameF32``; the 1x1 convs and the 1-D
tower as f32 matmuls with TF32 off, ``F32Linear``), norms, activations,
residual adds and pools on f32 values with no bf16 rounding between
layers, every max pool on ``MaxPool2d``, a residual matched by one
average window (``AvgPool2d``), and no layer fused. The JAX package's
packed Pallas layers would run in bf16 on a TPU whatever the setting: a
TPU lowering the port does not copy (``ROADMAP.md`` §3).

Layers get their input channel counts from ``in_channels`` or, when a
config leaves it unset, from their parent (``CNN`` / the CRNN glue), which
calls ``build``.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from pb_sed_tpu_torch.ops.dropout import dropout
from pb_sed_tpu_torch.ops.kernels.conv import (AvgPool2d, AvgPoolFreq2,
                                               BnReluConv2dSame, Conv2dSame,
                                               Conv2dSameF32, MaxPool2d,
                                               MaxPoolFreq2)
from pb_sed_tpu_torch.ops.linear import Bf16Linear, F32Linear
from pb_sed_tpu_torch.ops.masking import sequence_mask
from pb_sed_tpu_torch.parallel.mesh import global_sum
from pb_sed_tpu_torch.utils.config import Configurable
from pb_sed_tpu_torch.utils.misc import to_list


def update_running_stats(module, mean, var, momentum):
    """The running-stat update of the JAX package's norms: the first
    training call seeds the statistics (momentum 0 while ``initialized``
    is 0), later ones mix them in with ``momentum``."""
    with torch.no_grad():
        m = torch.where(module.initialized > 0, momentum, 0.)
        module.mean.mul_(m).add_((1. - m) * mean.detach())
        module.var.mul_(m).add_((1. - m) * var.detach())
        module.initialized.fill_(1.)


class MaskedMoments(torch.autograd.Function):
    """Masked f32 sum and sum of squares of ``x`` over all axes but the
    last. Autograd of ``x.float().square()`` would keep the f32 copy of
    ``x`` for the backward; this keeps ``x`` in its own dtype and
    recomputes the copy. The gradient is the same expression autograd
    forms, ``(g1 + 2·x·g2)·mask`` in f32, cast to ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(x, mask)
        xf = x.float()
        axes = tuple(range(x.dim() - 1))
        return (xf * mask).sum(axes), (xf.square() * mask).sum(axes)

    @staticmethod
    def backward(ctx, g1, g2):
        x, mask = ctx.saved_tensors
        return ((g1 + 2. * x.float() * g2) * mask).to(x.dtype), None


class MaskedBatchNorm(nn.Module):
    """Batch norm over the channel (last) axis in f32 whatever the input
    dtype. In training (``self.training``) the statistics are taken over
    the valid frames only (``seq_len`` along axis 1), single-pass sum and
    sum of squares in f32, ``var = max(E[x^2] - mean^2, 0)``
    (``pb_sed_tpu/ops/cnn.py:190-214``), and the running statistics are
    updated; in eval mode the running statistics normalize. With
    ``fold=True`` the same statistics (and updates) give the affine
    ``(scale, shift) = (rsqrt(var + eps) * gamma, beta - mean * scale)``
    instead of the normalized buffer (``pb_sed_tpu/ops/cnn.py:184-187``);
    gradients reach gamma, beta and, in training, x through it. Under a
    ``parallel.mesh.data_parallel`` shard the sums and the count are the
    global batch's (one all-reduce a layer), so every rank normalizes
    with, and keeps, the statistics one device would take on the whole
    batch."""

    def __init__(self, channels, eps=1e-3, momentum=0.95):
        super().__init__()
        self.train(False)  # the JAX default: training=False
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.shift = nn.Parameter(torch.zeros(channels))
        self.register_buffer('mean', torch.zeros(channels))
        self.register_buffer('var', torch.ones(channels))
        self.register_buffer('initialized', torch.zeros(()))

    def forward(self, x, seq_len, fold=False):
        # unfolded, the normalize reads the f32 copy too: the moments take
        # it, so both cotangents meet in f32 and round to x's dtype once
        xf = x if fold else x.float()
        if not self.training:
            mean, var = self.mean, self.var
        else:
            mask = sequence_mask(seq_len, x.shape[1])
            mask = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
            total, total_sq = MaskedMoments.apply(xf, mask)
            total, total_sq, valid = global_sum(total, total_sq, mask.sum())
            count = (valid * math.prod(x.shape[2:-1])).clamp(min=1.)
            mean = total / count
            var = (total_sq / count - mean.square()).clamp(min=0.)
            update_running_stats(self, mean, var, self.momentum)
        if fold:
            scale = torch.rsqrt(var + self.eps) * self.scale
            return scale, self.shift - mean * scale
        return (xf - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.shift


def _hard_sigmoid(x):
    return F.relu6(x + 3.) / 6.


def _standardize(x):
    """flax's ``standardize`` over the channel axis: ``(x - mean) *
    rsqrt(max(E[x^2] - mean^2, 0) + 1e-5)``."""
    mean = x.mean(-1, keepdim=True)
    var = (x.square().mean(-1, keepdim=True) - mean.square()).clamp(min=0.)
    return (x - mean) * torch.rsqrt(var + 1e-5)


# flax.linen's shape-keeping activations (flax 0.12), by the JAX package's
# names; ``softmax``, ``log_softmax`` and ``standardize`` act over the
# channel (last) axis, as flax's defaults do
_ACTIVATIONS = {
    'relu': torch.relu,
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'gelu': lambda x: F.gelu(x, approximate='tanh'),  # flax's default
    'elu': F.elu,
    'celu': F.celu,
    'selu': F.selu,
    'silu': F.silu,
    'swish': F.silu,
    'softplus': lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    'leaky_relu': lambda x: F.leaky_relu(x, .01),
    'relu6': F.relu6,
    'hard_tanh': F.hardtanh,
    'hard_sigmoid': _hard_sigmoid,
    'hard_silu': lambda x: x * _hard_sigmoid(x),
    'hard_swish': lambda x: x * _hard_sigmoid(x),
    'log_sigmoid': F.logsigmoid,
    'soft_sign': F.softsign,
    'softmax': lambda x: torch.softmax(x, -1),
    'log_softmax': lambda x: torch.log_softmax(x, -1),
    'standardize': _standardize,
    'normalize': _standardize,
}


def _act(name):
    """The activation the JAX package takes by ``getattr(flax.linen,
    name)``, with flax's formulas (``gelu`` its tanh approximation,
    ``leaky_relu`` slope 0.01, ``softplus`` ``logaddexp(x, 0)``). Names
    that change the shape (``glu``, ``one_hot``, ``logsumexp``) and names
    flax does not have raise, naming the name."""
    if name in (None, 'identity', 'linear'):
        return lambda x: x
    if name not in _ACTIVATIONS:
        raise ValueError(
            f'activation {name!r}: the towers take the shape-keeping '
            f'activations of flax.linen ({", ".join(sorted(_ACTIVATIONS))})')
    return _ACTIVATIONS[name]


def _compute_dtype(compute_dtype):
    """The torch dtype of a tower's ``compute_dtype``: 'bfloat16', or
    'float32' (and None, which the JAX package reads as float32,
    ``pb_sed_tpu/ops/cnn.py:_dtype``); any other value raises, naming
    it."""
    if compute_dtype == 'bfloat16':
        return torch.bfloat16
    if compute_dtype in (None, 'float32'):
        return torch.float32
    raise NotImplementedError(
        f'compute_dtype {compute_dtype!r}: the port computes convs in '
        f'bfloat16 or float32')


def _match_residual(res, shape, pairs=True):
    """A saved residual matched to a use site of ``shape`` as f32, grown
    channels zero-padded (``pb_sed_tpu/ops/cnn.py:_match_residual``,
    ``_match_residual_packed``). With ``pairs`` (every pool it crossed was
    (2, 1) on an even F: the JAX package's packed case) row pairs are
    averaged once per crossed pool; otherwise ONE average pool of window
    ``(T_res // T, F_res // F)`` (time only for a (B, T, C) residual), as
    the JAX package's unpacked path takes it. The last average pass writes
    the padded channels itself."""
    cout = shape[-1]
    if cout < res.shape[-1]:
        raise ValueError(f'residual of {res.shape[-1]} channels cannot '
                         f'join {cout}')
    if res.dim() == 4 and pairs:
        while res.shape[2] > shape[2]:
            last = res.shape[2] == 2 * shape[2]
            res = AvgPoolFreq2.apply(res, cout if last else res.shape[3])
    elif tuple(res.shape[1:-1]) != tuple(shape[1:-1]):
        st = res.shape[1] // shape[1] or 1
        sf = (res.shape[2] // shape[2] or 1) if res.dim() == 4 else 1
        if st > 1 or sf > 1:
            if res.dim() == 4:
                res = AvgPool2d.apply(res, st, sf, cout)
            else:
                res = AvgPool2d.apply(res[:, :, None], st, 1, cout)[:, :, 0]
    res = res.float()
    if res.shape[-1] < cout:
        res = nn.functional.pad(res, (0, cout - res.shape[-1]))
    return res


def _add_pending(pending, i, h):
    """``h`` plus the residuals pending at layer ``i``, summed in f32 in
    the order they were saved. Each pending entry is ``[residual, pairs]``
    (:func:`_match_residual`)."""
    if i not in pending:
        return h
    acc = h.float()
    for res, pairs in pending.pop(i):
        acc = acc + _match_residual(res, acc.shape, pairs)
    return acc


def _cross_pool(pending, stream):
    """A 2-D pool that is not the (2, 1) stream pool (``stream`` False)
    turns every pending residual, which all cross it, to the one-window
    match."""
    if not stream:
        for entries in pending.values():
            for entry in entries:
                entry[1] = False


def _pool_fp_tp(pool):
    """Reference pool notation (freq, time) or scalar -> ints."""
    if isinstance(pool, (tuple, list)):
        return int(pool[0]), int(pool[1])
    return int(pool), int(pool)


class Conv2d(nn.Module):
    """SAME conv (XLA's pads) on (B, T, F, Cin) in ``dtype``. bf16 -> bf16:
    the conv kernel, or for a 1x1 kernel one bf16 matmul with the same
    rounding (``ops/linear.py:Bf16Linear``; forward and backward 3x
    faster than the conv kernel at the deep recipe's L17 on an NVIDIA
    H100 80GB HBM3 at 700 W, ``PERF.md``). f32 -> f32 (``compute_dtype=
    'float32'``): the f32 conv kernel (``Conv2dSameF32``), or for a 1x1
    kernel one f32 matmul with TF32 off (``F32Linear``)."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 dtype=torch.bfloat16):
        super().__init__()
        kt, kf = kernel_size
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.zeros(kt, kf, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        f32 = self.dtype == torch.float32
        if self.kernel.shape[:2] == (1, 1):
            y = (F32Linear if f32 else Bf16Linear).apply(
                x.reshape(-1, x.shape[-1]), self.kernel[0, 0], self.bias)
            return y.reshape(*x.shape[:-1], y.shape[-1])
        return (Conv2dSameF32 if f32 else Conv2dSame).apply(
            x, self.kernel, self.bias)


class Conv1d(nn.Module):
    """SAME conv over time on (B, T, Cin), returned as f32. In bf16: bf16
    operands with f32 accumulation rounded to bf16, bias added in bf16
    (the arithmetic of the JAX package's ``nn.Conv(dtype=bfloat16)``). In
    f32 (``compute_dtype='float32'``, ``nn.Conv(dtype=float32)``): f32
    operands, TF32 off, f32 bias (``F32Linear``). Runs as one matmul over
    the k time-shifted copies of the input."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.zeros(kernel_size, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        k, cin, cout = self.kernel.shape
        x = x.to(self.dtype)
        if k > 1:
            t = x.shape[1]
            front = (k - 1) // 2
            xp = nn.functional.pad(x, (0, 0, front, k - 1 - front))
            x = torch.cat([xp[:, i:i + t] for i in range(k)], dim=-1)
        w = self.kernel.reshape(k * cin, cout)
        if self.dtype == torch.float32:
            y = F32Linear.apply(x.reshape(-1, k * cin), w, self.bias)
            return y.reshape(*x.shape[:-1], cout)
        y = torch.matmul(x, w.to(torch.bfloat16))
        return (y + self.bias.to(torch.bfloat16)).float()


class _Tower(nn.Module, Configurable):
    """Shared layer plumbing of the 2-D and 1-D towers."""

    def _build_layers(self, in_channels, make_conv):
        if self.built_channels is not None:
            if self.built_channels != in_channels:
                raise ValueError(
                    f'{type(self).__name__} built for {self.built_channels} '
                    f'input channels, asked for {in_channels}')
            return
        n = len(self.out_channels)
        cin = in_channels
        for i in range(n):
            is_output = self.output_layer and i == n - 1
            c_norm = cin if self.pre_activation else self.out_channels[i]
            if self.norm == 'batch' and not is_output:
                self.add_module(f'norm_{i}',
                                MaskedBatchNorm(c_norm, **self.norm_kwargs))
            self.add_module(f'conv_{i}',
                            make_conv(cin, self.out_channels[i], i))
            cin = self.out_channels[i]
        self.built_channels = in_channels

    def _norm_act(self, i, h, seq_len):
        """Norm, activation and dropout (in training) of layer ``i``, in
        f32 (``pb_sed_tpu/ops/cnn.py:636-641, 651-656, 707-724``)."""
        if self.norm == 'batch':
            h = getattr(self, f'norm_{i}')(h, seq_len)
        return dropout(self.act(h.float()), self.dropout, self.training,
                       type(self).__name__)


class CNN2d(_Tower):
    """Stack of 2-D convolutions over (time, freq) on (B, T, F, C).

    ``use_pallas`` comes from the JAX package's configs and has no
    effect: on CUDA the port always runs its kernels, on the CPU their
    plain versions. ``kernel_size`` is any extent per layer, an int or
    (kt, kf); ``pool_size`` any max pool per layer in the reference's
    (freq, time) notation or a scalar (both axes), VALID, with ``seq_len``
    ``ceil(seq_len / pt)`` after a time pool; ``norm`` 'batch' or anything
    else for no norm; ``activation_fn`` any shape-keeping flax name.
    ``fuse_bn`` folds each eligible layer's batch norm and ReLU into its
    conv's input load (:meth:`fused_layers`).
    ``residual_connections[i] = j`` adds layer i's output to layer j's.
    ``dropout`` acts after each activation in training, as in the JAX
    package, and then no layer fuses. With ``dropout`` > 0 the JAX tower
    takes its unpacked path in eval too (``pb_sed_tpu/ops/cnn.py:
    366-370``); the port keeps the packed path's rounding points there
    (``ROADMAP.md`` §3)."""

    def __init__(self, out_channels, kernel_size=3, pool_size=1,
                 residual_connections=None, norm='batch', norm_kwargs=None,
                 activation_fn='relu', pre_activation=False, dropout=0.,
                 output_layer=False, compute_dtype='bfloat16',
                 use_pallas=False, fuse_bn=False, in_channels=None,
                 input_height=None):
        super().__init__()
        self.train(False)  # the JAX default: training=False
        n = len(out_channels)
        self.dtype = _compute_dtype(compute_dtype)
        self.residuals = to_list(residual_connections or None, n)
        self.out_channels = list(out_channels)
        self.kernels = [(int(k), int(k)) if not isinstance(k, (tuple, list))
                        else tuple(int(e) for e in k)
                        for k in to_list(kernel_size, n)]
        pools = (list(pool_size) if isinstance(pool_size, (list, tuple))
                 and len(pool_size) == n else pool_size)
        self.pools = [_pool_fp_tp(p) for p in to_list(pools, n)]
        self.input_height = input_height
        self.norm = norm
        self.norm_kwargs = dict(norm_kwargs or {})
        self.act = _act(activation_fn)
        self.pre_activation = pre_activation
        self.dropout = dropout
        self.output_layer = output_layer
        # with dropout the JAX tower refuses its packed plan, so nothing
        # fuses (and the mask sits between the ReLU and the conv); an f32
        # tower runs the JAX package's unpacked path, which fuses nothing
        self.fuse_bn = (fuse_bn and pre_activation and norm == 'batch'
                        and activation_fn == 'relu' and dropout == 0
                        and self.dtype == torch.bfloat16)
        self.fused = frozenset()
        self.built_channels = None
        if in_channels is not None:
            self.build(in_channels)

    def build(self, in_channels, height=None):
        """Create the layers for ``in_channels`` input channels; ``height``
        (default ``input_height``), the freq bins, decides the fused
        layers' even-F term (:meth:`fused_layers`)."""
        self._build_layers(in_channels, lambda cin, cout, i: Conv2d(
            cin, cout, self.kernels[i], self.dtype))
        if height is not None:
            self.input_height = height
        self.fused = self.fused_layers(in_channels, self.input_height)

    def fused_layers(self, in_channels, height=None):
        """The layers whose batch norm and ReLU fold into the conv with
        ``fuse_bn``, by the JAX package's per-layer terms
        (``pb_sed_tpu/ops/cnn.py:_packed_plan``, ``common_ok`` and the
        fused ``want``): a pre-activation ReLU batch-norm tower without
        dropout; an odd kernel larger than 1x1; input channels (not the
        channel-padded entry layer, Cin < 16) and output channels
        multiples of 16; no time pool, and a freq pool of 1 or 2 on an
        even F (F counted as the plan counts it, ``ceil(F / pf)`` after
        each pool; not checked while ``height`` is unknown); not the
        output layer. The JAX plan keeps only its longest run of such
        layers and drops a layer whose staging slab exceeds its TPU memory
        model: a TPU layout matter, so every eligible layer fuses here."""
        if not self.fuse_bn:
            return frozenset()
        n = len(self.out_channels)
        cins = [in_channels] + self.out_channels[:-1]
        fused = set()
        f = height
        for i, ((kt, kf), cin, cout, (pf, pt)) in enumerate(zip(
                self.kernels, cins, self.out_channels, self.pools)):
            even = f is None or pf == 1 or f % 2 == 0
            if (kt % 2 and kf % 2 and kt * kf > 1 and cin % 16 == 0
                    and cout % 16 == 0 and pt == 1 and pf in (1, 2) and even
                    and not (self.output_layer and i == n - 1)):
                fused.add(i)
            f = None if f is None else -(-f // pf)
        return frozenset(fused)

    def out_height(self, height):
        for pf, _ in self.pools:
            height //= pf
        return height

    def forward(self, x, seq_len):
        """(B, T, F, C) -> ((B, T', F', C') in the compute dtype,
        seq_len')."""
        n = len(self.out_channels)
        fused = self.fused_layers(self.built_channels, x.shape[2])
        bf16 = self.dtype == torch.bfloat16
        pending = {}
        h = x
        for i in range(n):
            is_output = self.output_layer and i == n - 1
            conv = getattr(self, f'conv_{i}')
            if i in fused:
                h = h.to(torch.bfloat16)
                scale, shift = getattr(self, f'norm_{i}')(h, seq_len,
                                                           fold=True)
                h = BnReluConv2dSame.apply(h, scale, shift, conv.kernel,
                                           conv.bias)
            else:
                if self.pre_activation and not is_output:
                    h = self._norm_act(i, h, seq_len)
                h = conv(h.to(self.dtype))
            if not self.pre_activation and not is_output:
                h = self._norm_act(i, h, seq_len).to(self.dtype)
            h = _add_pending(pending, i, h).to(self.dtype)
            if self.residuals[i] is not None:
                # an f32 tower matches residuals as the JAX package's
                # unpacked path: one average window
                pending.setdefault(int(self.residuals[i]), []).append(
                    [h, bf16])
            pf, pt = self.pools[i]
            if (pf, pt) != (1, 1):
                stream = (bf16 and (pf, pt) == (2, 1)
                          and h.shape[2] % 2 == 0)
                _cross_pool(pending, stream)
                h = (MaxPoolFreq2.apply(h) if stream
                     else MaxPool2d.apply(h, pt, pf))
                if pt > 1:
                    seq_len = -(-seq_len // pt)
        return h, seq_len


class CNN1d(_Tower):
    """Stack of 1-D convolutions over time on (B, T, C), with residual
    skips (``residual_connections[i] = j``) added in f32 and max pools
    over time (``pool_size``) on the f32 values, VALID, ``seq_len``
    ``ceil(seq_len / p)`` (``MaxPool2d``)."""

    def __init__(self, out_channels, kernel_size=3, pool_size=1,
                 residual_connections=None, norm='batch', norm_kwargs=None,
                 activation_fn='relu', pre_activation=False, dropout=0.,
                 output_layer=False, compute_dtype='bfloat16',
                 in_channels=None):
        super().__init__()
        self.train(False)  # the JAX default: training=False
        n = len(out_channels)
        self.dtype = _compute_dtype(compute_dtype)
        self.residuals = to_list(residual_connections or None, n)
        self.out_channels = list(out_channels)
        self.kernels = to_list(
            list(kernel_size) if isinstance(kernel_size, (list, tuple))
            else kernel_size, n)
        self.pools = [int(p) for p in to_list(pool_size, n)]
        self.norm = norm
        self.norm_kwargs = dict(norm_kwargs or {})
        self.act = _act(activation_fn)
        self.pre_activation = pre_activation
        self.dropout = dropout
        self.output_layer = output_layer
        self.built_channels = None
        if in_channels is not None:
            self.build(in_channels)

    def build(self, in_channels):
        self._build_layers(in_channels, lambda cin, cout, i: Conv1d(
            cin, cout, int(self.kernels[i]), self.dtype))

    def forward(self, x, seq_len):
        """(B, T, C) -> ((B, T, C') f32, seq_len)."""
        n = len(self.out_channels)
        pending = {}
        h = x
        for i in range(n):
            is_output = self.output_layer and i == n - 1
            if self.pre_activation and not is_output:
                h = self._norm_act(i, h, seq_len)
            h = getattr(self, f'conv_{i}')(h)
            if not self.pre_activation and not is_output:
                h = self._norm_act(i, h, seq_len)
            h = _add_pending(pending, i, h)
            if self.residuals[i] is not None:
                pending.setdefault(int(self.residuals[i]), []).append(
                    [h, True])
            if self.pools[i] > 1:
                h = MaxPool2d.apply(h[:, :, None], self.pools[i], 1)[:, :, 0]
                seq_len = -(-seq_len // self.pools[i])
        return h, seq_len


class CNN(nn.Module, Configurable):
    """2-D tower -> flatten freq into channels -> 1-D tower.

    Input (B, T, F) features are lifted to (B, T, F, 1) (or carry delta
    channels), optionally with a positional channel and a broadcast
    condition; the surviving freq bins fold into channels for the 1-D
    tower. Output (B, T, C) embeddings. The towers come in built by the
    config (``instantiate``); ``build`` sizes their layers."""

    def __init__(self, cnn_2d, cnn_1d, input_height=None,
                 positional_encoding=False, conditional_dims=0):
        super().__init__()
        self.cnn_2d = cnn_2d
        self.cnn_1d = cnn_1d
        self.input_height = input_height
        self.positional_encoding = positional_encoding
        self.conditional_dims = conditional_dims

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['cnn_2d'] = {'factory': CNN2d}
        config['cnn_1d'] = {'factory': CNN1d}

    @property
    def out_channels(self):
        return self.cnn_1d.out_channels[-1]

    def build(self, in_channels):
        """Create the towers' layers for ``in_channels`` feature channels
        at ``input_height`` freq bins."""
        if self.input_height is None:
            raise ValueError('CNN needs input_height to size its 1-D tower')
        c2d = (in_channels + int(self.positional_encoding)
               + self.conditional_dims)
        self.cnn_2d.build(c2d, self.input_height)
        self.cnn_1d.build(self.cnn_2d.out_height(self.input_height)
                          * self.cnn_2d.out_channels[-1])

    def forward(self, x, seq_len, condition=None):
        h = x[..., None] if x.dim() == 3 else x  # (B, T, F, C)
        b, t, f = h.shape[:3]
        if self.positional_encoding:
            pos = torch.linspace(-1., 1., f, device=h.device)
            h = torch.cat([h, pos.reshape(1, 1, f, 1).expand(b, t, f, 1)],
                          dim=-1)
        if self.conditional_dims and condition is not None:
            cond = condition[:, None, None, :].expand(
                b, t, f, condition.shape[-1])
            h = torch.cat([h, cond.to(h.dtype)], dim=-1)
        h, seq_len = self.cnn_2d(h, seq_len)
        b, t2, f2, c2 = h.shape
        h, seq_len = self.cnn_1d(h.reshape(b, t2, f2 * c2), seq_len)
        return h, seq_len
