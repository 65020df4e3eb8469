"""Full-size network presets (plain dicts, the same as
``pb_sed_tpu/models/net_configs.py``).

The 'shallow' / 'deep' net configurations of the reference recipes
(``pb_sed/experiments/weak_label_crnn/training.py:158-260``): 9 conv2d
layers 16->256 with 2x1 freq pooling x4 (shallow) or 18 conv2d layers with
residuals at width 2 (deep); 5 conv1d layers at 256*width; 2-layer GRU
hidden 256*width with a 1x1-conv output net; 128 log-mels with warping /
masking / noise augmentation.
"""
import numpy as np


def cnn_config(net_config='shallow', num_events=10):
    if net_config == 'shallow':
        width = 1
        kernel_size_2d = 3
        out_channels_2d = [
            16 * width, 16 * width, 32 * width, 32 * width, 64 * width,
            64 * width, 128 * width, 128 * width, min(256 * width, 512),
        ]
        residual_connections_2d = None
        pool_sizes_2d = 4 * [1, [2, 1]] + [1]
        kernel_size_1d = [1] + 3 * [3] + [1]
        residual_connections_1d = None
    elif net_config == 'deep':
        width = 2
        kernel_size_2d = 9 * [3, 1]
        out_channels_2d = (
            4 * [16 * width] + 4 * [32 * width] + 4 * [64 * width]
            + 4 * [128 * width] + [256 * width, min(256 * width, 512)]
        )
        residual_connections_2d = [
            None, None, 4, None, 6, None, 8, None, 10, None, 12, None,
            14, None, 16, None, None, None,
        ]
        pool_sizes_2d = 4 * [1, 1, 1, [2, 1]] + [1, 1]
        kernel_size_1d = [1] + 3 * [3, 1] + [1]
        residual_connections_1d = [None, 3, None, 5, None, 7, None, None]
    else:
        raise ValueError(f'Unknown net_config {net_config}')
    return width, {
        'cnn_2d': {
            'out_channels': out_channels_2d,
            'pool_size': pool_sizes_2d,
            'kernel_size': kernel_size_2d,
            'residual_connections': residual_connections_2d,
            'norm': 'batch',
            'norm_kwargs': {'eps': 1e-3},
            'activation_fn': 'relu',
            'pre_activation': True,
            'dropout': .0,
            'output_layer': False,
            # accepted for config compatibility; no effect in the port
            # (ops/cnn.py:CNN2d)
            'use_pallas': True,
        },
        'cnn_1d': {
            'out_channels': len(kernel_size_1d) * [256 * width],
            'kernel_size': kernel_size_1d,
            'residual_connections': residual_connections_1d,
            'norm': 'batch',
            'norm_kwargs': {'eps': 1e-3},
            'activation_fn': 'relu',
            'pre_activation': True,
            'dropout': .0,
            'output_layer': False,
        },
    }


def feature_extractor_config(sample_rate=16000, stft_size=1024,
                             number_of_filters=128, augment=True):
    config = {
        'sample_rate': sample_rate,
        'stft_size': stft_size,
        'number_of_filters': number_of_filters,
    }
    if augment:
        config.update({
            'frequency_warping': True,
            'warp_factor_scale': .08,
            'warp_factor_truncation': float(np.log(1.3)),
            'boundary_ratio_scale': .5,
            'boundary_ratio_truncation': 5.,
            'n_time_masks': 1,
            'max_masked_time_steps': 70,
            'max_masked_time_rate': .2,
            'n_frequency_masks': 1,
            'max_masked_frequency_bands': 20,
            'max_masked_frequency_rate': .2,
            'max_noise_scale': .2,
        })
    return config


def rnn_config(width, num_events, num_layers=2):
    return {
        'rnn': {
            'hidden_size': 256 * width,
            'num_layers': num_layers,
            'dropout': .0,
            # accepted for config compatibility; no effect in the port
            # (ops/rnn.py:StackedGRU)
            'use_pallas': True,
        },
        'output_net': {
            'out_channels': [256 * width, num_events],
            'kernel_size': 1,
            'norm': 'batch',
            'norm_kwargs': {'eps': 1e-3},
            'activation_fn': 'relu',
            'dropout': .0,
        },
    }


def fbcrnn_config(net_config='shallow', num_events=10,
                  sample_rate=16000, stft_size=1024,
                  number_of_filters=128, augment=True,
                  strong_fwd_bwd_loss_weight=1.):
    """Full weak-label FBCRNN model config dict (factory-style)."""
    width, cnn = cnn_config(net_config, num_events)
    return {
        'feature_extractor': feature_extractor_config(
            sample_rate, stft_size, number_of_filters, augment),
        'cnn': cnn,
        'rnn_fwd': rnn_config(width, num_events),
        'labelwise_metrics': ('fscore_weak',),
        'strong_fwd_bwd_loss_weight': strong_fwd_bwd_loss_weight,
    }


def bicrnn_config(net_config='shallow', num_events=10,
                  sample_rate=16000, stft_size=1024,
                  number_of_filters=128, augment=True,
                  tag_conditioning=False):
    """Full strong-label BiCRNN model config dict (factory-style)."""
    width, cnn = cnn_config(net_config, num_events)
    # reference strong recipe: bidirectional, hidden 256*width,
    # num_layers 2 (``strong_label_crnn/training.py:245-250``)
    rnn = rnn_config(width, num_events, num_layers=2)
    rnn['rnn']['bidirectional'] = True
    return {
        'feature_extractor': feature_extractor_config(
            sample_rate, stft_size, number_of_filters, augment),
        'cnn': cnn,
        'rnn': rnn,
        'tag_conditioning': tag_conditioning,
        'labelwise_metrics': ('fscore_strong',),
    }
