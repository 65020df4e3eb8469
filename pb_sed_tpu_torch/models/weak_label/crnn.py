"""FBCRNN (forward-backward CRNN) for weak-label sound event detection.

Counterpart of ``pb_sed_tpu/models/weak_label/crnn.py``: log-mel front
end, hybrid CNN, a forward and a time-reversed backward GRU head (or
Transformer head, ``ops/rnn.py:TransformerEncoder``), bounded
sigmoid scores, the training loss (:meth:`CRNN.loss`, the JAX
``CRNN.loss_fn``) and the inference methods ``tagging`` (mean of the
forward head's last and the backward head's first frame),
``boundaries_detection`` (min of the heads) and sliding-window
``sound_event_detection`` (windows folded into the batch, scalar,
per-class or per-paramset window lengths). Scores are time-last
``(B, K, T)``. The tuning wrappers ``tune_tagging``,
``tune_boundary_detection`` and ``tune_sound_event_detection`` run the
models over a dataset into score frames and tune on them
(``models/base/tuning.py``); ``device`` is accepted as in the JAX
package, the models run on their own device.
"""
import numpy as np
import torch
from torch import nn

from pb_sed_tpu_torch.models.base.model import SoundEventModel, to_numpy
from pb_sed_tpu_torch.ops.cnn import CNN
from pb_sed_tpu_torch.ops.features import NormalizedLogMelExtractor
from pb_sed_tpu_torch.ops.masking import (compute_mask, masked_mean,
                                          take_last)
from pb_sed_tpu_torch.ops.rnn import GRU, paired_gru_apply, paired_heads
from pb_sed_tpu_torch.parallel.mesh import global_mean, global_sum


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

    def features(self, batch, generator=None):
        """Features from 'audio_data' (device STFT, time-warped in
        training where the batch carries 'warp_anchor_out') or a shipped
        'stft'; ``generator`` feeds the training augmentation."""
        seq_len = batch['seq_len']
        if 'audio_data' in batch:
            warp = None
            if self.training and 'warp_anchor_out' in batch:
                warp = (batch['warp_anchor_out'], batch['warp_anchor_in'],
                        batch['seq_len_samples'])
            x = self.feature_extractor(
                batch['audio_data'], seq_len, generator=generator,
                warp_params=warp)
        else:
            x = self.feature_extractor(batch['stft'], seq_len,
                                       generator=generator)
        return x, seq_len

    def encode(self, batch, generator=None):
        x, seq_len = self.features(batch, generator)
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

    def forward(self, batch, generator=None):
        h, seq_len_h, x, seq_len_x = self.encode(batch, generator)
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


def _feature_image(x):
    """The summary image of the features: the first three examples
    (with delta channels, their base channel), as JAX returns it."""
    return (x[:3] if x.dim() == 3 else x[:3, ..., 0]).detach()


class CRNN(SoundEventModel):
    """FBCRNN wrapper: training loss, inference API and config glue."""

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

    # -- training loss --------------------------------------------------------
    def loss(self, batch, generator=None):
        """The JAX ``CRNN.loss_fn`` (``pb_sed_tpu/models/weak_label/
        crnn.py:219-320``) on a batch of device tensors, in the module's
        current mode (``train()`` for batch statistics and augmentation),
        all in f32:

        - weak targets in (.01, .99) are soft (unlabeled) and masked out;
        - weak loss: BCE(max(y_fwd, y_bwd), weak) over frames;
        - strong loss: BCE against the boundary targets' cummax forward
          (y_fwd) and backward (y_bwd), for classes that are fully
          frame-labeled and weakly positive, mixed in by
          ``strong_fwd_bwd_loss_weight`` (SLAT: weak targets as boundary
          targets);
        - label smoothing clips targets, BCE clips scores at 1e-7;
        - masked mean over frames, class-weighted mean over (B, K).

        Under a ``parallel.mesh.data_parallel`` shard the loss is the
        global batch's: the class-weighted sum and the weights' sum are
        summed over the ranks before the ratio, and so are the scalars'
        means.

        Returns ``(loss, aux)`` with ``aux = {'scalars': ..., 'buffers':
        ..., 'images': ...}``, the JAX function's scalars, buffers and
        summary image (the first three examples' features).
        """
        y_fwd, y_bwd, seq_len_y, x, _ = self.module(batch, generator)
        weak_targets = batch['weak_targets'].float()
        wt_mask = ((weak_targets < .01) | (weak_targets > .99)).float()
        weak_targets = weak_targets * wt_mask
        loss = self._weak_fwd_bwd_loss(
            y_fwd, y_bwd, weak_targets, seq_len_y) * wt_mask[..., None]
        boundary_label_rate = torch.zeros((), device=y_fwd.device)
        if self.strong_fwd_bwd_loss_weight > 0.:
            if self.slat:
                boundary_targets = weak_targets[..., None].expand(
                    y_fwd.shape)
            else:
                boundary_targets = batch['boundary_targets'].float()
            bt_mask = ((boundary_targets > .99)
                       | (boundary_targets < .01)).float()
            frame_mask = compute_mask(boundary_targets, seq_len_y,
                                      sequence_axis=-1)
            fully_labeled = (masked_mean(bt_mask, seq_len_y, axis=-1,
                                         keepdims=True) > .999).float()
            bt_mask = (bt_mask * fully_labeled
                       * (weak_targets > .99)[..., None].float()
                       * frame_mask)
            boundary_label_rate = global_mean(bt_mask)
            strong_loss = self._strong_fwd_bwd_loss(
                y_fwd, y_bwd, boundary_targets)
            w = bt_mask * self.strong_fwd_bwd_loss_weight
            loss = w * strong_loss + (1. - w) * loss
        loss = masked_mean(loss, seq_len_y, axis=-1)  # (B, K)
        weights = wt_mask
        if self.class_weights is not None:
            weights = weights * torch.as_tensor(
                self.class_weights, dtype=torch.float32,
                device=weights.device)
        total, weight = global_sum((loss * weights).sum(), weights.sum())
        loss = total / weight.clamp(min=1.)
        y_weak = take_last(y_fwd, seq_len_y, axis=-1)
        if y_bwd is not None:
            y_weak = y_weak / 2 + y_bwd[..., 0] / 2
        scalars = {
            'seq_len': global_mean(batch['seq_len'].float()),
            'weak_label_rate': global_mean(wt_mask),
            'boundary_label_rate': boundary_label_rate,
        }
        buffers = {
            'y_weak': y_weak.detach(),
            'targets_weak': weak_targets,
            'labeled_mask': (wt_mask == 1.).all(-1),
        }
        return loss, {'scalars': scalars, 'buffers': buffers,
                      'images': {'features': _feature_image(x)}}

    def _clip_targets(self, targets):
        if self.label_smoothing > 0.:
            return targets.clamp(self.label_smoothing,
                                 1. - self.label_smoothing)
        return targets

    @staticmethod
    def _bce(y, t):
        y = y.clamp(1e-7, 1. - 1e-7)
        return -(t * torch.log(y) + (1. - t) * torch.log(1. - y))

    def _weak_fwd_bwd_loss(self, y_fwd, y_bwd, targets, seq_len):
        targets = self._clip_targets(targets)
        if y_bwd is None:
            y_weak = take_last(y_fwd, seq_len, axis=-1)
            return self._bce(y_weak, targets)[..., None].expand(y_fwd.shape)
        return self._bce(torch.maximum(y_fwd, y_bwd), targets[..., None])

    def _strong_fwd_bwd_loss(self, y_fwd, y_bwd, targets):
        targets = self._clip_targets(targets)
        t_fwd = torch.cummax(targets, dim=-1).values
        t_bwd = torch.cummax(targets.flip(-1), dim=-1).values.flip(-1)
        loss = self._bce(y_fwd, t_fwd)
        if y_bwd is not None:
            loss = loss / 2 + self._bce(y_bwd, t_bwd) / 2
        return loss

    # -- host-facing review ---------------------------------------------------
    def review_from_aux(self, loss, aux):
        """One step's ``loss`` and ``aux`` (of :meth:`loss`) on the host:
        float scalars and the clip scores and targets of the fully
        labeled examples, for the summary's metrics."""
        buffers = aux['buffers']
        labeled = to_numpy(buffers['labeled_mask'])
        return {
            'loss': float(loss),
            'scalars': {k: float(v) for k, v in aux['scalars'].items()},
            'buffers': {
                'y_weak': to_numpy(buffers['y_weak'])[labeled],
                'targets_weak': to_numpy(buffers['targets_weak'])[labeled],
            },
        }

    def modify_summary(self, summary):
        if 'targets_weak' in summary.get('buffers', {}):
            self.add_metrics_to_summary(summary, 'weak')
        return super().modify_summary(summary)

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


# ----------------------------------------------------------------------
# tuning wrappers (the JAX package's crnn.py:402-463)
# ----------------------------------------------------------------------
def tune_tagging(crnns, dataset, timestamps, event_classes, metrics,
                 minimize=False, storage_dir=None, device=None):
    from pb_sed_tpu_torch.models import base
    print('\nTagging Tuning')
    tagging_scores = base.tagging(
        crnns, dataset, timestamps=timestamps, event_classes=event_classes)
    return base.tune_tagging(
        tagging_scores, medfilt_length_candidates=[1], metrics=metrics,
        minimize=minimize, storage_dir=storage_dir)


def tune_boundary_detection(
        crnns, dataset, timestamps, event_classes, tags, metrics,
        stepfilt_lengths, minimize=False, tag_masking='?',
        storage_dir=None, device=None):
    from pb_sed_tpu_torch.models import base
    print('\nBoundaries Detection Tuning')
    boundaries_scores = base.boundaries_detection(
        crnns, dataset, stepfilt_length=None, apply_mask=False, masks=tags,
        timestamps=timestamps, event_classes=event_classes)
    return base.tune_boundaries_detection(
        boundaries_scores, medfilt_length_candidates=[1],
        stepfilt_length_candidates=stepfilt_lengths, tags=tags,
        metrics=metrics, minimize=minimize, tag_masking=tag_masking,
        storage_dir=storage_dir)


def tune_sound_event_detection(
        crnns, dataset, timestamps, event_classes, tags, metrics,
        window_lengths, window_shift, medfilt_lengths,
        minimize=False, tag_masking='?', storage_dir=None, device=None):
    from pb_sed_tpu_torch.models import base
    print('\nSound Event Detection Tuning')
    leaderboard = {}
    for win_len in window_lengths:
        print(f'\n### window_length={win_len} ###')
        detection_scores = base.sound_event_detection(
            crnns, dataset,
            model_kwargs={'window_length': win_len,
                          'window_shift': window_shift},
            timestamps=timestamps[::window_shift],
            event_classes=event_classes)
        lb = base.tune_sound_event_detection(
            detection_scores, medfilt_lengths, tags, metrics=metrics,
            minimize=minimize, tag_masking=tag_masking,
            storage_dir=storage_dir)
        for metric_name, (metric_values, hyper_params, scores) in lb.items():
            for event_class in event_classes:
                hyper_params[event_class]['window_length'] = win_len
                hyper_params[event_class]['window_shift'] = window_shift
            leaderboard = base.update_leaderboard(
                leaderboard, metric_name, metric_values, hyper_params,
                scores, minimize=minimize)
    print('\nbest overall:')
    for metric_name in metrics:
        print(f'\n{metric_name}:')
        print(leaderboard[metric_name][0])
    return leaderboard
