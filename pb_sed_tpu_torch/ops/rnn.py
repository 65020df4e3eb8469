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
bidirectional layer runs both directions as one D=2 recurrence. The
Transformer head and inter-layer dropout in training are not ported yet
and raise.
"""
import torch
from torch import nn

from pb_sed_tpu_torch.ops.cnn import CNN1d, check_dropout
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
    versions. ``dropout`` > 0 between layers raises in training (not
    ported yet)."""

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

    def check_dropout(self):
        """Dropout acts between layers in training (not ported yet)."""
        check_dropout(self, self.dropout if self.num_layers > 1 else 0.)

    def forward(self, x, seq_len=None):
        """``seq_len`` (None: every sequence full) places the backward
        direction's reversal in a bidirectional GRU."""
        self.check_dropout()
        h = x
        for layer in self.gru_layers:
            h = layer(h, seq_len) if self.bidirectional else layer(h)
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
    recurrence per layer (:func:`paired_gru_apply`)."""
    if not isinstance(head_f, GRU) or not isinstance(head_b, GRU):
        return False
    if head_f.reverse or not head_b.reverse:
        return False
    cf, cb = head_f.rnn, head_b.rnn
    for core in (cf, cb):
        if isinstance(core, StackedGRU):
            core.check_dropout()
    return (isinstance(cf, StackedGRU) and isinstance(cb, StackedGRU)
            and not (cf.bidirectional or cb.bidirectional)
            and cf.num_layers == cb.num_layers
            and cf.hidden_size == cb.hidden_size)


def paired_gru_apply(head_f, head_b, x, seq_len):
    """Both heads with each layer's two recurrences in ONE D=2
    ``gru_scan``; same values as ``head_f(x, seq_len)`` and
    ``head_b(x, seq_len)``. Returns ``(y_fwd, y_bwd, seq_len_out)``."""
    rev_len = seq_len
    if seq_len is None:
        seq_len = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                             device=x.device)
    b = x.shape[0]
    h_f = x
    h_b = reverse_sequence(x, rev_len, axis=1)
    for lf, lb in zip(head_f.rnn.gru_layers, head_b.rnn.gru_layers):
        xw = torch.stack([lf.project(h_f), lb.project(h_b)])
        w_hh = torch.stack([lf.w_hh, lb.w_hh])
        b_hh = torch.stack([lf.b_hh, lb.b_hh])
        h0 = torch.zeros(2, b, lf.hidden_size, device=x.device)
        h_f, h_b = GruScan.apply(xw, w_hh, b_hh, h0)
    y_f, seq_out = head_f.output_net(h_f, seq_len)
    y_b, _ = head_b.output_net(reverse_sequence(h_b, rev_len, axis=1),
                               seq_len)
    return y_f, y_b, seq_out
