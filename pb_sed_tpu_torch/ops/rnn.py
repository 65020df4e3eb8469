"""Recurrent heads: unidirectional and bidirectional GRU layers on the
``gru_scan`` kernel, the stacked GRU, the ``GRU`` head (optionally
time-reversed, the FBCRNN's backward head) with its 1x1-conv output net,
and the paired application of the FBCRNN's forward and backward heads as
one D=2 recurrence per layer.

Counterpart of ``pb_sed_tpu/ops/rnn.py`` with its parameter layouts and
names: ``layer_{i}_fwd.{w_ih (F, 3H), w_hh (H, 3H), b_ih, b_hh}`` and,
stacked over the two directions, ``layer_{i}_bi.{w_ih (2, F, 3H),
w_hh (2, H, 3H), b_ih (2, 1, 3H), b_hh (2, 1, 3H)}``, in torch gate order
(r, z, n). The input projections of all timesteps are one bf16 matmul
outside the recurrence, with the f32 input bias inside its one rounding
(``ops/linear.py:Bf16Linear``); the recurrence is the autograd Function
``ops/kernels/gru.py:GruScan`` (forward and backward kernels). A
bidirectional layer runs both directions as one D=2 recurrence. Between
stacked layers, dropout acts in training (``ops/dropout.py``).

The Transformer head (:class:`TransformerEncoder`, the JAX package's
``ops/rnn.py:403-491``): an input projection, causal pre-LayerNorm blocks
of multi-head self-attention and a ReLU feed-forward net, and the 1x1
output net, all in f32 as flax's ``Dense`` and
``MultiHeadDotProductAttention`` compute them (the JAX package computes
attention outside any kernel; plain matmuls here, TF32 off, torch's
default). Parameter names and layouts are flax's: ``in_proj.{kernel
(F, Hd), bias}``, ``block_{i}.LayerNorm_{0,1}.{scale, bias}``,
``block_{i}.MultiHeadDotProductAttention_0.{query,key,value}.{kernel
(Hd, heads, Hd/heads), bias (heads, Hd/heads)}`` and ``.out.{kernel
(heads, Hd/heads, Hd), bias}``, ``block_{i}.Dense_{0,1}.{kernel, bias}``.
"""
import math

import torch
from torch import nn

from pb_sed_tpu_torch.ops.cnn import CNN1d
from pb_sed_tpu_torch.ops.dropout import (apply_keep, attention_dropout,
                                          dropout, keep_mask)
from pb_sed_tpu_torch.ops.kernels.gru import GruScan
from pb_sed_tpu_torch.ops.linear import Bf16Linear
from pb_sed_tpu_torch.ops.masking import reverse_sequence
from pb_sed_tpu_torch.utils.config import Configurable


class GRULayer(nn.Module):
    """One unidirectional GRU layer, (B, T, F) -> (B, T, H)."""

    def __init__(self, hidden_size, input_size, bias=True):
        super().__init__()
        g = 3 * hidden_size
        self.hidden_size = hidden_size
        self.input_size = input_size
        self.w_ih = nn.Parameter(torch.zeros(input_size, g))
        self.w_hh = nn.Parameter(torch.zeros(hidden_size, g))
        if bias:
            self.b_ih = nn.Parameter(torch.zeros(g))
            self.b_hh = nn.Parameter(torch.zeros(g))
        else:
            self.register_buffer('b_ih', torch.zeros(g), persistent=False)
            self.register_buffer('b_hh', torch.zeros(g), persistent=False)

    def project(self, x):
        """(B, T, F) -> (B, T, 3H) bf16 input projections plus input bias,
        rounded once, the type the recurrence reads: the JAX package's
        ``jnp.dot(..., preferred_element_type=f32) + b_ih``
        (``pb_sed_tpu/ops/rnn.py:95-101``) streamed as bf16
        (``ops/pallas/gru.py:178``). ``dw_ih`` is the bf16 matmul's."""
        return _project(x, self.w_ih, self.b_ih, self.input_size)

    def forward(self, x, h0=None):
        b = x.shape[0]
        if h0 is None:
            h0 = torch.zeros(b, self.hidden_size, device=x.device)
        return GruScan.apply(self.project(x)[None], self.w_hh[None],
                             self.b_hh[None], h0[None])[0]


def _project(x, w_ih, b_ih, input_size):
    """(B, T, F) -> (B, T, 3H): ``Bf16Linear`` over all timesteps."""
    if x.shape[-1] != input_size:
        raise ValueError(f'GRU layer expects {input_size} input features, '
                         f'got {x.shape[-1]}')
    y = Bf16Linear.apply(x.reshape(-1, x.shape[-1]), w_ih, b_ih)
    return y.reshape(*x.shape[:-1], y.shape[-1])


class BiGRULayer(nn.Module):
    """One bidirectional GRU layer, (B, T, F) -> (B, T, 2H) = [fwd, bwd].

    The counterpart of the JAX package's ``BiGRULayer``
    (``pb_sed_tpu/ops/rnn.py:141-207``): parameters stacked over the two
    directions, both directions' input projections as bf16 matmuls with
    the f32 input bias inside their one rounding (the einsum at
    ``:168-171``, streamed as bf16), and both recurrences in ONE D=2
    ``gru_scan`` from a zero state. The backward direction reads its
    input mask-reversed (``x[sl - 1 - t]`` for ``t < sl``) and its output
    is reversed back with the same lengths, so padding never enters its
    recurrence before a valid frame."""

    def __init__(self, hidden_size, input_size, bias=True):
        super().__init__()
        g = 3 * hidden_size
        self.hidden_size = hidden_size
        self.input_size = input_size
        self.w_ih = nn.Parameter(torch.zeros(2, input_size, g))
        self.w_hh = nn.Parameter(torch.zeros(2, hidden_size, g))
        if bias:
            self.b_ih = nn.Parameter(torch.zeros(2, 1, g))
            self.b_hh = nn.Parameter(torch.zeros(2, 1, g))
        else:
            self.register_buffer('b_ih', torch.zeros(2, 1, g),
                                 persistent=False)
            self.register_buffer('b_hh', torch.zeros(2, 1, g),
                                 persistent=False)

    def forward(self, x, seq_len):
        rev = reverse_sequence(x, seq_len, axis=1)
        xw = torch.stack([
            _project(h, self.w_ih[d], self.b_ih[d, 0], self.input_size)
            for d, h in enumerate((x, rev))])
        h0 = torch.zeros(2, x.shape[0], self.hidden_size, device=x.device)
        y_f, y_b = GruScan.apply(xw, self.w_hh, self.b_hh[:, 0], h0)
        return torch.cat([y_f, reverse_sequence(y_b, seq_len, axis=1)],
                         dim=-1)


class StackedGRU(nn.Module, Configurable):
    """Multi-layer GRU, unidirectional (``layer_{i}_fwd``) or
    bidirectional (``layer_{i}_bi``, each layer after the first reading
    the 2H features of the one before).

    ``use_pallas`` comes from the JAX package's configs and has no effect:
    on CUDA the port always runs the GRU kernels, on the CPU their plain
    versions. ``dropout`` acts on the output of every layer but the last
    in training (``pb_sed_tpu/ops/rnn.py:267-268``)."""

    def __init__(self, hidden_size, num_layers=1, bias=True, dropout=0.,
                 bidirectional=False, use_pallas=False, input_size=None):
        super().__init__()
        self.train(False)  # the JAX default: training=False
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bias = bias
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.input_size = None
        if input_size is not None:
            self.build(input_size)

    @property
    def output_size(self):
        return 2 * self.hidden_size if self.bidirectional else \
            self.hidden_size

    def build(self, input_size):
        """Create the layers for ``input_size`` input features (configs
        may leave ``input_size`` unset; the parent head sets it)."""
        if self.input_size is not None:
            if self.input_size != input_size:
                raise ValueError(f'StackedGRU built for {self.input_size} '
                                 f'input features, asked for {input_size}')
            return
        layer, suffix = ((BiGRULayer, 'bi') if self.bidirectional
                         else (GRULayer, 'fwd'))
        for i in range(self.num_layers):
            self.add_module(f'layer_{i}_{suffix}', layer(
                self.hidden_size, input_size if i == 0 else self.output_size,
                self.bias))
        self.input_size = input_size

    @property
    def gru_layers(self):
        suffix = 'bi' if self.bidirectional else 'fwd'
        return [getattr(self, f'layer_{i}_{suffix}')
                for i in range(self.num_layers)]

    def between_layers(self, h, i):
        """Layer ``i``'s output as the next layer reads it: dropped out in
        training unless it is the last layer."""
        if i == self.num_layers - 1:
            return h
        return dropout(h, self.dropout, self.training, 'StackedGRU')

    def forward(self, x, seq_len=None):
        """``seq_len`` (None: every sequence full) places the backward
        direction's reversal in a bidirectional GRU."""
        h = x
        for i, layer in enumerate(self.gru_layers):
            h = layer(h, seq_len) if self.bidirectional else layer(h)
            h = self.between_layers(h, i)
        return h


class GRU(nn.Module, Configurable):
    """GRU + output net, the recurrent head of the FBCRNN and the BiCRNN.

    ``reverse=True`` is the backward head: the input is sequence-reversed
    before the recurrence and the output reversed back, so ``y[t]``
    summarizes frames ``t..T-1``."""

    def __init__(self, rnn=None, output_net=None, reverse=False):
        """``rnn`` (a ``StackedGRU`` or None) and ``output_net`` (a
        ``CNN1d``) come in built by the config (``instantiate``)."""
        super().__init__()
        self.rnn = rnn
        self.output_net = output_net
        self.reverse = reverse
        if rnn is not None:
            output_net.build(rnn.output_size)

    @classmethod
    def finalize_dogmatic_config(cls, config):
        if config.get('rnn') is not None:
            config['rnn'] = {
                'factory': StackedGRU,
                'hidden_size': 256,
                'num_layers': 1,
                'dropout': 0.,
                'bidirectional': False,
                'bias': True,
            }
        config['output_net'] = {
            'factory': CNN1d,
            'out_channels': [256, 10],
            'kernel_size': 1,
            'norm': 'batch',
            'activation_fn': 'relu',
            'dropout': 0.,
            'output_layer': True,
        }

    def build(self, in_channels):
        """Size the head for ``in_channels`` input features."""
        if self.rnn is None:
            self.output_net.build(in_channels)
        else:
            self.rnn.build(in_channels)

    def forward(self, x, seq_len):
        """(B, T, C) -> ((B, T, K) scores, seq_len). ``seq_len=None``
        (sliding windows) means every sequence is full."""
        rev_len = seq_len
        if seq_len is None:
            seq_len = torch.full((x.shape[0],), x.shape[1],
                                 dtype=torch.int32, device=x.device)
        h = x
        if self.rnn is not None:
            if self.reverse:
                h = reverse_sequence(h, rev_len, axis=1)
            h = self.rnn(h, seq_len)
            if self.reverse:
                h = reverse_sequence(h, rev_len, axis=1)
        return self.output_net(h, seq_len)


def paired_heads(head_f, head_b):
    """Whether the FBCRNN's forward and backward heads can run as one D=2
    recurrence per layer (:func:`paired_gru_apply`). Unlike the JAX
    package, heads with dropout between their layers pair too: the paired
    lane draws each head's masks in the unpaired lane's order. It needs
    output nets that draw none, as every recipe's do."""
    if not isinstance(head_f, GRU) or not isinstance(head_b, GRU):
        return False
    if head_f.reverse or not head_b.reverse:
        return False
    cf, cb = head_f.rnn, head_b.rnn
    return (isinstance(cf, StackedGRU) and isinstance(cb, StackedGRU)
            and not (cf.bidirectional or cb.bidirectional)
            and cf.num_layers == cb.num_layers
            and cf.hidden_size == cb.hidden_size
            and not (head_f.training and (head_f.output_net.dropout
                                          or head_b.output_net.dropout)))


def _between_layers(core, x):
    """``core``'s (a StackedGRU's) inter-layer dropout as one function per
    layer of that layer's output, with its masks drawn now, in the order
    the unpaired lane draws them."""
    out = []
    for i in range(core.num_layers):
        if i == core.num_layers - 1 or not core.training or not core.dropout:
            out.append(lambda h: h)
            continue
        keep = keep_mask((*x.shape[:-1], core.hidden_size), core.dropout,
                         x.device, 'StackedGRU')
        out.append(lambda h, keep=keep: apply_keep(h, keep, core.dropout))
    return out


def paired_gru_apply(head_f, head_b, x, seq_len):
    """Both heads with each layer's two recurrences in ONE D=2
    ``gru_scan``; same values as ``head_f(x, seq_len)`` and
    ``head_b(x, seq_len)``, dropout included (the forward head's masks
    are drawn before the backward head's, as the heads in turn draw
    them). Returns ``(y_fwd, y_bwd, seq_len_out)``."""
    rev_len = seq_len
    if seq_len is None:
        seq_len = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                             device=x.device)
    b = x.shape[0]
    h_f = x
    h_b = reverse_sequence(x, rev_len, axis=1)
    drop_f = _between_layers(head_f.rnn, x)
    drop_b = _between_layers(head_b.rnn, x)
    for i, (lf, lb) in enumerate(zip(head_f.rnn.gru_layers,
                                     head_b.rnn.gru_layers)):
        xw = torch.stack([lf.project(h_f), lb.project(h_b)])
        w_hh = torch.stack([lf.w_hh, lb.w_hh])
        b_hh = torch.stack([lf.b_hh, lb.b_hh])
        h0 = torch.zeros(2, b, lf.hidden_size, device=x.device)
        h_f, h_b = GruScan.apply(xw, w_hh, b_hh, h0)
        h_f, h_b = drop_f[i](h_f), drop_b[i](h_b)
    y_f, seq_out = head_f.output_net(h_f, seq_len)
    y_b, _ = head_b.output_net(reverse_sequence(h_b, rev_len, axis=1),
                               seq_len)
    return y_f, y_b, seq_out


class _Dense(nn.Module):
    """flax ``nn.Dense`` in f32: ``x @ kernel + bias``, kernel (F, M)."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return x @ self.kernel + self.bias


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last axis: epsilon 1e-6 and the
    fast variance ``max(E[x^2] - E[x]^2, 0)``, applied as ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, features, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp(min=0.)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class _HeadsProjection(nn.Module):
    """A query, key or value projection of flax's attention (its
    ``DenseGeneral`` to (heads, head_dim)): kernel (F, heads, head_dim),
    bias (heads, head_dim)."""

    def __init__(self, features, heads, head_dim):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(features, heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(heads, head_dim))

    def forward(self, x):
        return torch.einsum('btf,fhd->bthd', x, self.kernel) + self.bias


class _OutProjection(nn.Module):
    """The attention's output ``DenseGeneral`` over (heads, head_dim):
    kernel (heads, head_dim, F), bias (F,)."""

    def __init__(self, heads, head_dim, features):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(heads, head_dim, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, y):
        return torch.einsum('bthd,hdf->btf', y, self.kernel) + self.bias


class _SelfAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads, qkv_features=
    features)`` on ``(x, x)``: the query divided by sqrt(head_dim) before
    the product, masked logits set to the f32 minimum, softmax in f32,
    the attention dropout on the weights (one (Tq, Tk) mask shared by the
    batch and the heads), then the output projection."""

    def __init__(self, features, heads):
        super().__init__()
        if features % heads:
            raise ValueError(f'{features} features do not split into '
                             f'{heads} heads')
        head_dim = features // heads
        self.query = _HeadsProjection(features, heads, head_dim)
        self.key = _HeadsProjection(features, heads, head_dim)
        self.value = _HeadsProjection(features, heads, head_dim)
        self.out = _OutProjection(heads, head_dim, features)

    def forward(self, x, mask, rate):
        q, k, v = self.query(x), self.key(x), self.value(x)
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum('bqhd,bkhd->bhqk', q, k)
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        weights = attention_dropout(torch.softmax(logits, dim=-1), rate,
                                    self.training)
        return self.out(torch.einsum('bhqk,bkhd->bqhd', weights, v))


class _TransformerBlock(nn.Module):
    """One pre-LayerNorm block (``pb_sed_tpu/ops/rnn.py:472-491``):
    ``x + attention(LN(x))``, then ``x + Dense(dropout(relu(Dense(
    LN(x)))))``."""

    def __init__(self, hidden_size, d_ff, num_heads, dropout_rate):
        super().__init__()
        self.dropout = dropout_rate
        self.LayerNorm_0 = _LayerNorm(hidden_size)
        self.MultiHeadDotProductAttention_0 = _SelfAttention(hidden_size,
                                                             num_heads)
        self.LayerNorm_1 = _LayerNorm(hidden_size)
        self.Dense_0 = _Dense(hidden_size, d_ff)
        self.Dense_1 = _Dense(d_ff, hidden_size)

    def forward(self, x, mask):
        x = x + self.MultiHeadDotProductAttention_0(
            self.LayerNorm_0(x), mask, self.dropout)
        h = torch.relu(self.Dense_0(self.LayerNorm_1(x)))
        h = dropout(h, self.dropout, self.training, 'TransformerEncoder')
        return x + self.Dense_1(h)


class TransformerEncoder(nn.Module, Configurable):
    """The causal Transformer alternative to the GRU head (the JAX
    package's ``TransformerEncoder``, the reference's
    ``experiments/weak_label_crnn/training.py:275-281``): ``in_proj`` to
    ``hidden_size``, ``num_layers`` blocks (:class:`_TransformerBlock`)
    under a causal mask whose keys lie below ``seq_len``, then the output
    net. ``reverse=True`` (the FBCRNN's backward head) reverses the valid
    frames before the blocks and after them. ``rnn`` is a plain dict
    (``hidden_size``, ``d_ff``, ``num_layers``, ``dropout``,
    ``num_heads``; the config glue adds ``input_size``)."""

    def __init__(self, rnn=None, output_net=None, reverse=False):
        super().__init__()
        self.train(False)  # the JAX default: training=False
        cfg = dict(rnn or {})
        cfg.pop('factory', None)
        input_size = cfg.pop('input_size', None)
        self.hidden_size = cfg.get('hidden_size', 256)
        self.d_ff = cfg.get('d_ff', 1024)
        self.num_layers = cfg.get('num_layers', 6)
        self.dropout = cfg.get('dropout', .2)
        self.num_heads = cfg.get('num_heads', 8)
        self.output_net = output_net
        self.reverse = reverse
        for i in range(self.num_layers):
            self.add_module(f'block_{i}', _TransformerBlock(
                self.hidden_size, self.d_ff, self.num_heads, self.dropout))
        output_net.build(self.hidden_size)
        self.input_size = None
        if input_size is not None:
            self.build(input_size)

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['rnn'] = {
            'hidden_size': 256, 'd_ff': 1024, 'num_layers': 6,
            'dropout': .2, 'num_heads': 8,
        }
        config['output_net'] = {
            'factory': CNN1d,
            'out_channels': [256, 10],
            'kernel_size': 1,
            'norm': 'batch',
            'activation_fn': 'relu',
            'dropout': 0.,
            'output_layer': True,
        }

    def build(self, in_channels):
        """Create ``in_proj`` for ``in_channels`` input features."""
        if self.input_size is not None:
            if self.input_size != in_channels:
                raise ValueError(
                    f'TransformerEncoder built for {self.input_size} input '
                    f'features, asked for {in_channels}')
            return
        self.in_proj = _Dense(in_channels, self.hidden_size)
        self.input_size = in_channels

    def forward(self, x, seq_len):
        """(B, T, C) -> ((B, T, K) scores, seq_len); ``seq_len=None``
        (sliding windows) means every sequence is full."""
        rev_len = seq_len
        if seq_len is None:
            seq_len = torch.full((x.shape[0],), x.shape[1],
                                 dtype=torch.int32, device=x.device)
        h = x.float()
        if self.reverse:
            h = reverse_sequence(h, rev_len, axis=1)
        h = self.in_proj(h)
        pos = torch.arange(h.shape[1], device=h.device)
        causal = pos[None, :] <= pos[:, None]               # (Tq, Tk)
        valid = pos[None, :] < seq_len[:, None]             # (B, Tk)
        mask = causal[None, None] & valid[:, None, None, :]
        for i in range(self.num_layers):
            h = getattr(self, f'block_{i}')(h, mask)
        if self.reverse:
            h = reverse_sequence(h, rev_len, axis=1)
        return self.output_net(h, seq_len)
