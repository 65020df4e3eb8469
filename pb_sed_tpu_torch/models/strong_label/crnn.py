"""BiCRNN: the bidirectional CRNN for strong-label sound event detection,
optionally tag-conditioned.

Counterpart of ``pb_sed_tpu/models/strong_label/crnn.py``: log-mel front
end, hybrid CNN, one ``GRU`` head whose core is a bidirectional
``StackedGRU`` (both directions of a layer in one D=2 ``gru_scan``), and
plain sigmoid frame scores ``(B, K, T)``. With ``tag_conditioning`` the
clip's weak tags (``batch['tag_condition']``, (B, K)) enter twice: as
extra CNN input channels (``CNN(conditional_dims=K)``) and broadcast over
time and concatenated to the CNN output before the RNN. ``tagging`` is
the max over the valid frames, ``sound_event_detection`` the masked frame
scores. The training loss (:meth:`CRNN.loss`) is the JAX ``loss_fn``:
frame BCE against ``strong_targets`` with soft (0.5) targets masked out;
the review buffers are frame scores max-pooled over
``eval_segment_length`` blocks. The tuning wrappers run the models over a
dataset into score frames and tune on them (``models/base/tuning.py``);
``device`` is accepted as in the JAX package, the models run on their own
device.
"""
import numpy as np
import torch
from torch import nn

from pb_sed_tpu_torch.models.base.model import SoundEventModel, to_numpy
from pb_sed_tpu_torch.models.weak_label.crnn import (  # noqa: F401
    FBCRNNModule, _feature_image, tune_tagging)
from pb_sed_tpu_torch.ops.cnn import CNN
from pb_sed_tpu_torch.ops.features import NormalizedLogMelExtractor
from pb_sed_tpu_torch.ops.masking import (compute_mask, masked_max,
                                          masked_mean)
from pb_sed_tpu_torch.ops.rnn import GRU
from pb_sed_tpu_torch.parallel.mesh import global_mean, global_sum


class BiCRNNModule(nn.Module):
    """The BiCRNN computation graph. ``forward(batch)`` returns
    ``(y (B, K, T), seq_len_y, x, seq_len_x)``."""

    def __init__(self, feature_extractor, cnn, rnn, tag_conditioning=False):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.cnn = cnn
        self.rnn = rnn
        self.tag_conditioning = tag_conditioning
        cnn.build(feature_extractor.out_channels)
        rnn.build(cnn.out_channels + (cnn.conditional_dims
                                      if tag_conditioning else 0))

    # the FBCRNN's front end: the device STFT (time-warped in training)
    # or a shipped 'stft', then the log-mel features
    features = FBCRNNModule.features

    def forward(self, batch, generator=None):
        x, seq_len_x = self.features(batch, generator)
        condition = None
        if self.tag_conditioning:
            condition = batch.get('tag_condition')
            if condition is not None:
                condition = condition.float()
        h, seq_len_h = self.cnn(x, seq_len_x, condition=condition)
        if condition is not None:
            b, t, _ = h.shape
            h = torch.cat([h.float(), condition[:, None, :].expand(
                b, t, condition.shape[-1])], dim=-1)
        y, seq_len_y = self.rnn(h, seq_len_h)
        y = torch.sigmoid(y).transpose(1, 2)  # (B, K, T)
        return y, seq_len_y, x, seq_len_x

    def tagging(self, batch):
        """Clip tags: max over the valid frames. Returns ((B, K, 1), ones
        (B,))."""
        y, seq_len_y, *_ = self(batch)
        return (masked_max(y, seq_len_y, axis=-1, keepdims=True),
                torch.ones_like(seq_len_y))

    def boundaries_detection(self, batch):
        return self.sound_event_detection(batch)

    def sound_event_detection(self, batch):
        y, seq_len_y, *_ = self(batch)
        mask = compute_mask(y, seq_len_y, sequence_axis=-1)
        return y * mask, seq_len_y


class CRNN(SoundEventModel):
    """BiCRNN wrapper: training loss, inference API and config glue."""

    def __init__(self, feature_extractor, cnn, rnn, *,
                 tag_conditioning=False, labelwise_metrics=(),
                 label_mapping=None, test_labels=None,
                 eval_segment_length=1):
        super().__init__(
            labelwise_metrics=labelwise_metrics,
            label_mapping=label_mapping, test_labels=test_labels)
        self.module = BiCRNNModule(
            feature_extractor=feature_extractor, cnn=cnn, rnn=rnn,
            tag_conditioning=tag_conditioning)
        self.tag_conditioning = tag_conditioning
        self.eval_segment_length = eval_segment_length

    # -- training loss --------------------------------------------------------
    def loss(self, batch, generator=None):
        """The JAX ``CRNN.loss_fn`` (``pb_sed_tpu/models/strong_label/
        crnn.py:97-134``) on a batch of device tensors, in the module's
        current mode, all in f32: frames whose target lies in (.01, .99)
        are unknown and masked, as are padded frames; BCE on scores
        clipped to [1e-7, 1 - 1e-7] (not ``F.binary_cross_entropy``,
        which clamps the log at -100), summed and divided by the number
        of certain entries (at least 1).

        Under a ``parallel.mesh.data_parallel`` shard the sums and the
        scalars' means are the global batch's.

        Returns ``(loss, aux)`` with ``aux = {'scalars': ..., 'buffers':
        ..., 'images': ...}``: the buffers are the frame scores and targets
        max-pooled over ``eval_segment_length`` blocks, ``(B, n_seg, K)``,
        and the mask of the valid segments of the fully labeled clips; the
        images the first three examples' features and strong targets, as
        JAX returns them."""
        y, seq_len_y, x, _ = self.module(batch, generator)
        targets = batch['strong_targets'].float()          # (B, K, T)
        st_mask = ((targets > .99) | (targets < .01)).float()
        st_mask = st_mask * compute_mask(y, seq_len_y, sequence_axis=-1)
        y_c = y.clamp(1e-7, 1. - 1e-7)
        bce = -(targets * torch.log(y_c)
                + (1. - targets) * torch.log(1. - y_c)) * st_mask
        total, certain = global_sum(bce.sum(), st_mask.sum())
        loss = total / certain.clamp(min=1.)
        fully_labeled = (masked_mean(st_mask, seq_len_y, axis=-1)
                         > .999).all(-1)                      # (B,)
        scalars = {
            'seq_len': global_mean(batch['seq_len'].float()),
            'strong_label_rate': global_mean(st_mask),
        }
        seg = int(self.eval_segment_length)
        b, k, t = y.shape
        y_seg, t_seg = y.detach(), targets
        n_seg = t
        if seg > 1:
            n_seg = t // seg
            y_seg, t_seg = (v[..., :n_seg * seg].reshape(b, k, n_seg, seg)
                            .amax(-1) for v in (y_seg, t_seg))
        seg_valid = (torch.arange(n_seg, device=y.device)[None, :]
                     < (seq_len_y[:, None] + seg - 1) // seg)  # (B, n_seg)
        buffers = {
            'y_strong': y_seg.transpose(1, 2),
            'targets_strong': t_seg.transpose(1, 2),
            'segment_mask': seg_valid & fully_labeled[:, None],
        }
        images = {'features': _feature_image(x),
                  'strong_targets': targets[:3]}
        return loss, {'scalars': scalars, 'buffers': buffers,
                      'images': images}

    # -- host-facing review ---------------------------------------------------
    def review_from_aux(self, loss, aux):
        """One step's ``loss`` and ``aux`` (of :meth:`loss`) on the host:
        float scalars and the segment scores and targets of the valid
        segments of the fully labeled clips, (N, K), for the summary's
        metrics."""
        buffers = aux['buffers']
        seg_mask = to_numpy(buffers['segment_mask']).reshape(-1)
        y = to_numpy(buffers['y_strong'])
        t = to_numpy(buffers['targets_strong'])
        return {
            'loss': float(loss),
            'scalars': {k: float(v) for k, v in aux['scalars'].items()},
            'buffers': {
                'y_strong': y.reshape(-1, y.shape[-1])[seg_mask],
                'targets_strong': t.reshape(-1, t.shape[-1])[seg_mask],
            },
        }

    def modify_summary(self, summary):
        if 'targets_strong' in summary.get('buffers', {}):
            self.add_metrics_to_summary(summary, 'strong')
        return super().modify_summary(summary)

    # -- inference API (numpy out) ------------------------------------------
    def tagging(self, batch, **params):
        y, seq_len = self._apply(batch, 'tagging')
        return to_numpy(y), to_numpy(seq_len)

    def boundaries_detection(self, batch, **params):
        return self.sound_event_detection(batch, **params)

    def sound_event_detection(self, batch, **params):
        y, seq_len = self._apply(batch, 'sound_event_detection')
        return to_numpy(y), to_numpy(seq_len)

    def dispatch(self, method, batch, **params):
        """The public methods' values as device tensors (returns before
        the device is done)."""
        if method == 'tagging':
            return self._apply(batch, 'tagging')
        if method in ('boundaries_detection', 'sound_event_detection'):
            return self._apply(batch, 'sound_event_detection')
        return super().dispatch(method, batch, **params)

    # -- config glue ----------------------------------------------------------
    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['feature_extractor'] = {'factory': NormalizedLogMelExtractor}
        config['cnn'] = {'factory': CNN}
        config['rnn'] = {'factory': GRU}
        num_filters = config['feature_extractor']['number_of_filters']
        config['cnn']['input_height'] = num_filters
        num_events = config['rnn']['output_net']['out_channels'][-1]
        if config['tag_conditioning']:
            config['cnn']['conditional_dims'] = num_events
        rnn_cfg = config['rnn'].get('rnn')
        if rnn_cfg is not None:
            rnn_cfg.update({
                'num_layers': 1, 'bias': True, 'dropout': 0.,
                'bidirectional': True,
            })
            input_size = config['cnn']['cnn_1d']['out_channels'][-1]
            if config['tag_conditioning']:
                input_size += num_events
            rnn_cfg['input_size'] = input_size


# ----------------------------------------------------------------------
# tuning wrappers (the JAX package's crnn.py:212-249; ``tune_tagging`` is
# the weak model's, imported above)
# ----------------------------------------------------------------------
def tune_boundary_detection(
        crnns, dataset, timestamps, event_classes, tags, metrics,
        stepfilt_lengths, minimize=False, tag_masking=True,
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
        medfilt_lengths, minimize=False, tag_masking='?',
        storage_dir=None, device=None):
    from pb_sed_tpu_torch.models import base
    print('\nSound Event Detection Tuning')
    detection_scores = base.sound_event_detection(
        crnns, dataset, timestamps=timestamps, event_classes=event_classes)
    return base.tune_sound_event_detection(
        detection_scores, medfilt_lengths, tags, metrics=metrics,
        minimize=minimize, tag_masking=tag_masking, storage_dir=storage_dir)
