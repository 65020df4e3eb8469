"""FBCRNN (forward-backward CRNN) for weak-label sound event detection:
the serving path.

Counterpart of ``pb_sed_tpu/models/weak_label/crnn.py``: log-mel front
end, hybrid CNN, a forward and a time-reversed backward GRU head, bounded
sigmoid scores, and the inference methods ``tagging`` (mean of the
forward head's last and the backward head's first frame),
``boundaries_detection`` (min of the heads) and sliding-window
``sound_event_detection`` (windows folded into the batch, scalar,
per-class or per-paramset window lengths). Scores are time-last
``(B, K, T)``. The training loss and the tuning wrappers are not ported
yet.
"""
import numpy as np
import torch
from torch import nn

from pb_sed_tpu_torch.models.base.model import SoundEventModel, to_numpy
from pb_sed_tpu_torch.ops.cnn import CNN
from pb_sed_tpu_torch.ops.features import NormalizedLogMelExtractor
from pb_sed_tpu_torch.ops.masking import compute_mask, take_last
from pb_sed_tpu_torch.ops.rnn import GRU, paired_gru_apply, paired_heads


class FBCRNNModule(nn.Module):
    """The FBCRNN computation graph. ``forward(batch)`` returns
    ``(y_fwd, y_bwd, seq_len_y, x, seq_len_x)`` with y as (B, K, T)."""

    def __init__(self, feature_extractor, cnn, rnn_fwd, rnn_bwd,
                 minimum_score=1e-5):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.cnn = cnn
        self.rnn_fwd = rnn_fwd
        self.rnn_bwd = rnn_bwd
        self.minimum_score = minimum_score
        cnn.build(feature_extractor.out_channels)
        for head in (rnn_fwd, rnn_bwd):
            if head is not None:
                head.build(cnn.out_channels)

    def _bounded_sigmoid(self, logits):
        return self.minimum_score + (
            1. - 2. * self.minimum_score) * torch.sigmoid(logits)

    def features(self, batch):
        """Features from 'audio_data' (device STFT) or a shipped 'stft'."""
        seq_len = batch['seq_len']
        x = batch['audio_data'] if 'audio_data' in batch else batch['stft']
        return self.feature_extractor(x, seq_len), seq_len

    def encode(self, batch):
        x, seq_len = self.features(batch)
        h, seq_len_h = self.cnn(x, seq_len)
        return h, seq_len_h, x, seq_len

    def _heads(self, h, seq_len):
        """Both heads' frame logits (y_bwd None without a backward head)."""
        if paired_heads(self.rnn_fwd, self.rnn_bwd):
            return paired_gru_apply(self.rnn_fwd, self.rnn_bwd, h, seq_len)
        y_fwd, seq_len_y = self.rnn_fwd(h, seq_len)
        y_bwd = (None if self.rnn_bwd is None
                 else self.rnn_bwd(h, seq_len)[0])
        return y_fwd, y_bwd, seq_len_y

    def forward(self, batch):
        h, seq_len_h, x, seq_len_x = self.encode(batch)
        y_fwd, y_bwd, seq_len_y = self._heads(h, seq_len_h)
        y_fwd = self._bounded_sigmoid(y_fwd).transpose(1, 2)
        if y_bwd is not None:
            y_bwd = self._bounded_sigmoid(y_bwd).transpose(1, 2)
        return y_fwd, y_bwd, seq_len_y, x, seq_len_x

    def tagging(self, batch):
        """Clip tags: mean of the forward head's last and the backward
        head's first frame. Returns ((B, K, 1), ones (B,))."""
        y_fwd, y_bwd, seq_len_y, *_ = self(batch)
        y = take_last(y_fwd, seq_len_y, axis=-1, keepdims=True)
        if y_bwd is not None:
            y = (y + y_bwd[..., :1]) / 2
        return y, torch.ones_like(seq_len_y)

    def boundaries_detection(self, batch):
        y_fwd, y_bwd, seq_len_y, *_ = self(batch)
        mask = compute_mask(y_fwd, seq_len_y, sequence_axis=-1)
        return torch.minimum(y_fwd * mask, y_bwd * mask), seq_len_y

    def sed_windows(self, batch, window_length, window_shift=1):
        """Sliding-window SED for one window length: frame i scores the
        clip-level tags of a window of the CNN embedding around it. The
        windows fold into the batch, so both heads run once over B * n
        sequences."""
        h, seq_len, *_ = self.encode(batch)
        b, t, c = h.shape
        wl, ws = int(window_length), int(window_shift)
        pad_front = (wl - ws) // 2 if wl > ws else 0
        n = -(-t // ws)
        pad_back = (n - 1) * ws + wl - pad_front - t
        hp = nn.functional.pad(h, (0, 0, pad_front, max(pad_back, 0)))
        # (B, n, C, wl) strided view -> (B * n, wl, C)
        windows = hp.unfold(1, wl, ws)[:, :n]
        windows = windows.permute(0, 1, 3, 2).reshape(b * n, wl, c)
        y_fwd, y_bwd, _ = self._heads(windows, None)
        y = self._bounded_sigmoid(y_fwd[:, -1])
        if y_bwd is not None:
            y = (y + self._bounded_sigmoid(y_bwd[:, 0])) / 2
        y = y.reshape(b, n, -1).transpose(1, 2)  # (B, K, n)
        return y, 1 + (seq_len - 1) // ws


def multi_window_sed(run_window, window_length, materialize=True):
    """Combine fixed-window SED runs under scalar / per-class (K,) /
    per-paramset (N, K) window lengths.

    Args:
        run_window: ``win_len -> (y (B, K, T), seq_len)``.
        window_length: scalar / (K,) / (N, K) ints.
        materialize: with a scalar window length, ``False`` returns the
            device tensors as launched; array-valued windows combine on
            the host and always return numpy.
    """
    window_length = np.array(window_length, dtype=int)
    if window_length.ndim == 0:
        y, seq_len = run_window(int(window_length))
        if not materialize:
            return y, seq_len
        return to_numpy(y), to_numpy(seq_len)
    y_out = None
    seq_len_y = None
    for win_len in np.unique(window_length.flatten()):
        yi, seq_len_y = run_window(int(win_len))
        yi = to_numpy(yi)
        b, k, t = yi.shape
        wl = window_length
        if wl.ndim == 1:
            if wl.shape[0] not in (1, k):
                raise ValueError(f'window lengths {wl.shape} for {k} classes')
            wl = np.broadcast_to(wl, (k,))
            mask = (wl == win_len)[None, :, None]
        else:
            if wl.ndim != 2 or wl.shape[1] not in (1, k):
                raise ValueError(f'window lengths {wl.shape} for {k} classes')
            wl = np.broadcast_to(wl, (wl.shape[0], k))
            yi = yi[:, None]
            mask = (wl == win_len)[None, :, :, None]
        if y_out is None:
            shape = (b, *wl.shape, t) if wl.ndim == 2 else (b, k, t)
            y_out = np.zeros(shape, dtype=yi.dtype)
        y_out = y_out + mask * yi
    return y_out, to_numpy(seq_len_y)


class CRNN(SoundEventModel):
    """FBCRNN wrapper: inference API and config glue. The loss settings
    (label smoothing, SLAT, loss weights, class weights) are kept for
    config compatibility and act in training only."""

    def __init__(
            self, feature_extractor, cnn, rnn_fwd, rnn_bwd,
            *, minimum_score=1e-5, label_smoothing=0.,
            labelwise_metrics=(), label_mapping=None, test_labels=None,
            slat=False, strong_fwd_bwd_loss_weight=1., class_weights=None,
    ):
        super().__init__(
            labelwise_metrics=labelwise_metrics,
            label_mapping=label_mapping, test_labels=test_labels,
        )
        self.module = FBCRNNModule(
            feature_extractor=feature_extractor, cnn=cnn,
            rnn_fwd=rnn_fwd, rnn_bwd=rnn_bwd, minimum_score=minimum_score)
        self.minimum_score = minimum_score
        self.label_smoothing = label_smoothing
        self.slat = slat
        self.strong_fwd_bwd_loss_weight = strong_fwd_bwd_loss_weight
        self.class_weights = (
            None if class_weights is None else np.asarray(class_weights))

    # -- inference API (numpy out) ------------------------------------------
    def tagging(self, batch, **params):
        y, seq_len = self._apply(batch, 'tagging')
        return to_numpy(y), to_numpy(seq_len)

    def boundaries_detection(self, batch, **params):
        y, seq_len = self._apply(batch, 'boundaries_detection')
        return to_numpy(y), to_numpy(seq_len)

    def sound_event_detection(self, batch, window_length, window_shift=1):
        """Scalar, per-class (K,) and per-paramset (N, K) window lengths."""
        return multi_window_sed(
            lambda win_len: self._apply(
                batch, 'sed_windows', window_length=win_len,
                window_shift=int(window_shift)),
            window_length)

    def dispatch(self, method, batch, **params):
        """The public methods' values as device tensors (returns before
        the device is done)."""
        if method in ('tagging', 'boundaries_detection'):
            return self._apply(batch, method)
        if method == 'sound_event_detection':
            ws = int(params.pop('window_shift', 1))
            return multi_window_sed(
                lambda win_len: self._apply(
                    batch, 'sed_windows', window_length=win_len,
                    window_shift=ws),
                params.pop('window_length'), materialize=False)
        return super().dispatch(method, batch, **params)

    # -- config glue ----------------------------------------------------------
    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['feature_extractor'] = {'factory': NormalizedLogMelExtractor}
        config['cnn'] = {'factory': CNN}
        config['rnn_fwd'] = {'factory': GRU}
        config['rnn_bwd'] = {}
        if config['rnn_bwd'] is not None:
            config['rnn_bwd'].update(config['rnn_fwd'].to_dict(),
                                     reverse=True)
            config['rnn_bwd']['reverse'] = True
        num_filters = config['feature_extractor']['number_of_filters']
        config['cnn']['input_height'] = num_filters
        rnn_cfg = config['rnn_fwd'].get('rnn')
        if rnn_cfg is not None:
            rnn_cfg['input_size'] = config['cnn']['cnn_1d'][
                'out_channels'][-1]
