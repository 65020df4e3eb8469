"""FBCRNN training experiment.

Counterpart of ``pb_sed_tpu/experiments/weak_label_crnn/training.py``, with
the same config and recipes: DESED recipe (dataset repeats, cached sets,
per-dataset batch quotas,
``40000 * (1 + 0.5 * uses_pseudo) * 16/bs`` iterations, lr 5e-4 with decay
1/5 at half, rampup, gradient clipping in finetune mode) and AudioSet
pre-training recipe (527 events, 1M*16/bs iterations, lr 1e-4, sqrt(.1)
decays, clip .1, no strong loss); shallow/deep net configs; init-checkpoint
surgery (transplant cnn+rnn, drop the output layer); CNN layer freezing;
DESED-test-clip filtering for AudioSet; validation hook on
``macro_fscore_weak``; LR-annealing breakpoints.

The run trains on the CUDA card (``device=None``); ``device=cpu`` runs it
on the CPU, and without a card and without that request it raises. The
init checkpoint may be one that either package's ``Trainer`` wrote. Where
the original chains into the tuning experiment (``validation_set_name`` not
``None``, the DESED default), this one trains, writes its checkpoints and
then raises a ``NotImplementedError`` that names the missing tuning
experiment; pass ``validation_set_name=None`` to end after training.

Run: ``python -m pb_sed_tpu_torch.experiments.weak_label_crnn.training with
database_name=desed batch_size=32 validation_set_name=None ...``
"""
import time
from pathlib import Path

from pb_sed_tpu_torch.data.provider import DataProvider
from pb_sed_tpu_torch.database.audioset.provider import AudioSetProvider
from pb_sed_tpu_torch.database.desed.provider import DESEDProvider
from pb_sed_tpu_torch.experiments.core import (
    Experiment, FileStorageObserver, print_config)
from pb_sed_tpu_torch.models import weak_label
from pb_sed_tpu_torch.models.base.model import default_device
from pb_sed_tpu_torch.models.net_configs import (
    cnn_config, feature_extractor_config, rnn_config)
from pb_sed_tpu_torch.paths import database_jsons_dir, storage_root
from pb_sed_tpu_torch.train.hooks import LRAnnealingHook
from pb_sed_tpu_torch.train.optimizer import Adam
from pb_sed_tpu_torch.train.trainer import Trainer
from pb_sed_tpu_torch.utils.checkpoint import load_payload
from pb_sed_tpu_torch.utils.misc import load_json, timestamp

ex_name = 'weak_label_crnn_training'
ex = Experiment(ex_name)


@ex.config
def config(cfg):
    cfg['delay'] = 0
    cfg['debug'] = False
    debug = cfg['debug']
    cfg['timestamp'] = timestamp() + ('_debug' if debug else '')
    cfg['group_name'] = cfg['timestamp']
    cfg['database_name'] = 'desed'
    database_name = cfg['database_name']
    cfg['storage_dir'] = str(
        storage_root / 'weak_label_crnn' / database_name / 'training'
        / cfg['group_name'] / cfg['timestamp'])
    storage_dir = cfg['storage_dir']
    cfg['resume'] = False
    if cfg['resume']:
        assert Path(storage_dir).exists()

    cfg['init_ckpt_path'] = None
    cfg['frozen_cnn_2d_layers'] = 0
    cfg['frozen_cnn_1d_layers'] = 0
    cfg['freeze_norm_stats'] = True
    cfg['finetune_mode'] = cfg['init_ckpt_path'] is not None
    finetune_mode = cfg['finetune_mode']

    if database_name == 'desed':
        cfg['external_data'] = True
        external_data = cfg['external_data']
        cfg['batch_size'] = 32
        batch_size = cfg['batch_size']
        cfg['data_provider'] = {
            'factory': DESEDProvider,
            'train_set': {
                'train_weak': 10 if external_data else 20,
                'train_strong': 10 if external_data else 0,
                'train_synthetic20': 2,
                'train_synthetic21': 1,
                'train_unlabel_in_domain': 0,
            },
            'cached_datasets':
                None if debug else ['train_weak', 'train_synthetic20'],
            'train_fetcher': {
                'batch_size': batch_size,
                'prefetch_workers': 2,
                'min_dataset_examples_in_batch': {
                    'train_weak': int(3 * batch_size / 32),
                    'train_strong':
                        int(6 * batch_size / 32) if external_data else 0,
                    'train_synthetic20': int(1 * batch_size / 32),
                    'train_synthetic21': int(2 * batch_size / 32),
                    'train_unlabel_in_domain': 0,
                },
            },
            'train_transform': {'provide_boundary_targets': True},
            'storage_dir': storage_dir,
        }
        cfg['num_events'] = 10
        DESEDProvider.get_config(cfg['data_provider'])
        cfg['validation_set_name'] = 'validation'
        cfg['validation_ground_truth_filepath'] = None
        cfg['eval_set_name'] = 'eval_public'
        cfg['eval_ground_truth_filepath'] = None
        uses_pseudo = cfg['data_provider']['train_set'][
            'train_unlabel_in_domain'] > 0
        cfg['num_iterations'] = int(
            40000 * (1 + 0.5 * uses_pseudo) * 16 / batch_size)
        cfg['checkpoint_interval'] = int(2000 * 16 / batch_size)
        cfg['summary_interval'] = 100
        cfg['lr'] = 5e-4
        cfg['n_back_off'] = 0
        cfg['back_off_patience'] = 10
        cfg['lr_decay_steps'] = [
            int(20000 * (1 + 0.5 * uses_pseudo) * 16 / batch_size)
        ] if cfg['n_back_off'] == 0 else []
        cfg['lr_decay_factor'] = 1 / 5
        cfg['lr_rampup_steps'] = (
            None if finetune_mode else int(2000 * 16 / batch_size))
        cfg['gradient_clipping'] = 1 if finetune_mode else 1e10
        cfg['strong_fwd_bwd_loss_weight'] = 1.
        cfg['early_stopping_patience'] = None
    elif database_name == 'audioset':
        cfg['batch_size'] = 32
        batch_size = cfg['batch_size']
        cfg['data_provider'] = {
            'factory': AudioSetProvider,
            'train_set': {'balanced_train': 1, 'unbalanced_train': 1},
            'train_fetcher': {
                'batch_size': batch_size,
                'prefetch_workers': 2,
            },
            'min_class_examples_per_epoch': 0.01,
            'storage_dir': storage_dir,
        }
        cfg['num_events'] = 527
        AudioSetProvider.get_config(cfg['data_provider'])
        cfg['validation_set_name'] = None
        cfg['validation_ground_truth_filepath'] = None
        cfg['eval_set_name'] = None
        cfg['eval_ground_truth_filepath'] = None
        cfg['num_iterations'] = int(1000000 * 16 / batch_size)
        cfg['checkpoint_interval'] = int(10000 * 16 / batch_size)
        cfg['summary_interval'] = int(1000 * 16 / batch_size)
        cfg['lr'] = 1e-4
        cfg['n_back_off'] = 0
        cfg['back_off_patience'] = 10
        cfg['lr_decay_steps'] = [
            int(600000 * 16 / batch_size),
            int(800000 * 16 / batch_size),
        ] if cfg['n_back_off'] == 0 else []
        cfg['lr_decay_factor'] = float(0.1 ** 0.5)
        cfg['lr_rampup_steps'] = int(2000 * 16 / batch_size)
        cfg['early_stopping_patience'] = None
        cfg['gradient_clipping'] = .1
        cfg['strong_fwd_bwd_loss_weight'] = 0.
    else:
        raise ValueError(f'Unknown database {database_name}.')
    cfg['filter_desed_test_clips'] = False
    cfg['hyper_params_tuning_batch_size'] = cfg['batch_size'] // 2

    cfg['net_config'] = 'shallow'
    width, cnn = cnn_config(cfg['net_config'], cfg['num_events'])
    cfg['trainer'] = {
        'factory': Trainer,
        'model': {
            'factory': weak_label.CRNN,
            'feature_extractor': feature_extractor_config(
                sample_rate=16000, stft_size=1024,
                number_of_filters=128, augment=True),
            'cnn': cnn,
            'rnn_fwd': rnn_config(width, cfg['num_events']),
            'labelwise_metrics': ['fscore_weak'],
            'strong_fwd_bwd_loss_weight':
                cfg['strong_fwd_bwd_loss_weight'],
        },
        'optimizer': {
            'factory': Adam,
            'lr': cfg['lr'],
            'gradient_clipping': cfg['gradient_clipping'],
        },
        'summary_trigger': [cfg['summary_interval'], 'iteration'],
        'checkpoint_trigger': [cfg['checkpoint_interval'], 'iteration'],
        'stop_trigger': [cfg['num_iterations'], 'iteration'],
        'storage_dir': storage_dir,
    }
    Trainer.get_config(cfg['trainer'])
    cfg['device'] = None
    cfg['track_emissions'] = False
    ex.observers.append(FileStorageObserver.create(storage_dir))


@ex.automain
def train(_config, debug, resume, delay, data_provider,
          filter_desed_test_clips, trainer, lr_rampup_steps, n_back_off,
          back_off_patience, lr_decay_steps, lr_decay_factor,
          early_stopping_patience, init_ckpt_path, frozen_cnn_2d_layers,
          frozen_cnn_1d_layers, freeze_norm_stats, validation_set_name,
          validation_ground_truth_filepath, eval_set_name,
          eval_ground_truth_filepath, device, track_emissions,
          hyper_params_tuning_batch_size):
    print('\n##### Training #####\n')
    print_config(_config)
    assert (n_back_off == 0) or (len(lr_decay_steps) == 0), (
        n_back_off, lr_decay_steps)
    if delay > 0:
        print(f'Sleep for {delay} seconds.')
        time.sleep(delay)
    device = default_device(device)

    data_provider = DataProvider.from_config(data_provider)
    data_provider.train_transform.label_encoder.initialize_labels(
        dataset=data_provider.db.get_dataset([
            key for key, reps in data_provider.train_set.items()
            if reps > 0
        ]),
        verbose=True,
    )
    data_provider.test_transform.label_encoder.initialize_labels()
    trainer = Trainer.from_config(trainer)
    trainer.model.to(device)
    trainer.model.label_mapping = []
    encoder = data_provider.train_transform.label_encoder
    for idx, label in sorted(encoder.inverse_label_mapping.items()):
        assert idx == len(trainer.model.label_mapping), (idx, label)
        trainer.model.label_mapping.append(
            label.replace(', ', '__').replace(' ', '').replace('(', '_')
            .replace(')', '_').replace("'", ''))

    if filter_desed_test_clips:
        desed_json = load_json(database_jsons_dir / 'desed.json')
        filter_example_ids = {
            clip_id.rsplit('_', maxsplit=2)[0][1:]
            for clip_id in (
                list(desed_json['datasets']['validation'].keys())
                + list(desed_json['datasets']['eval_public'].keys()))
        }
    else:
        filter_example_ids = None
    train_set = data_provider.get_train_set(
        filter_example_ids=filter_example_ids)
    validate_set = data_provider.get_validate_set()

    # initialize the weights, then do the init-checkpoint surgery
    trainer._ensure_ready()
    print('Params', trainer.model.num_parameters())

    if init_ckpt_path is not None:
        print('Load init params')
        # load_payload reads either package's checkpoints (a JAX run's
        # optimizer state needs no optax)
        flat = drop_output_layer(load_payload(init_ckpt_path)['model'])
        trainer.model.load_partial_state_dict(flat)
    if frozen_cnn_2d_layers or frozen_cnn_1d_layers:
        print(f'Freeze {frozen_cnn_2d_layers} cnn_2d layers and '
              f'{frozen_cnn_1d_layers} cnn_1d layers')
        trainer.freeze(
            make_cnn_freeze_predicate(
                frozen_cnn_2d_layers, frozen_cnn_1d_layers),
            freeze_norm_stats=freeze_norm_stats)
        print(f'froze {trainer.num_frozen()} tensors')

    if validate_set is not None:
        trainer.test_run(train_set, validate_set)
        trainer.register_validation_hook(
            validate_set, metric='macro_fscore_weak', maximize=True,
            back_off_patience=back_off_patience, n_back_off=n_back_off,
            lr_update_factor=lr_decay_factor,
            early_stopping_patience=early_stopping_patience)

    breakpoints = []
    if lr_rampup_steps is not None:
        breakpoints += [(0, 0.), (lr_rampup_steps, 1.)]
    for i, step in enumerate(lr_decay_steps):
        breakpoints += [(step, lr_decay_factor ** i),
                        (step, lr_decay_factor ** (i + 1))]
    if breakpoints:
        trainer.register_hook(LRAnnealingHook(
            breakpoints=breakpoints, unit='iteration'))

    trainer.train(train_set, resume=resume, device=device,
                  track_emissions=track_emissions)

    if validation_set_name is not None:
        raise NotImplementedError(
            f'training finished and its checkpoints are in '
            f'{trainer.storage_dir}, but the tuning experiment that '
            f'follows it (experiments.weak_label_crnn.tuning on '
            f'{validation_set_name!r}) is not part of this package yet; '
            f'pass validation_set_name=None to end after training')
    return str(trainer.storage_dir)


def drop_output_layer(flat_state_dict):
    """Remove the final output-net conv layer of both heads so a model
    pre-trained with a different class count can be transplanted."""
    out = {}
    for head in ('rnn_fwd', 'rnn_bwd'):
        indices = [
            int(key.split('.conv_')[1].split('.')[0])
            for key in flat_state_dict
            if f'{head}.head.conv_' in key
        ]
        last = max(indices) if indices else None
        for key, value in flat_state_dict.items():
            if last is not None and f'{head}.head.conv_{last}.' in key:
                continue
            out[key] = value
        flat_state_dict = out
        out = {}
    return flat_state_dict


def make_cnn_freeze_predicate(n_2d, n_1d):
    def predicate(path):
        for tower, n in (('tower_2d', n_2d), ('tower_1d', n_1d)):
            marker = f'cnn.{tower}.'
            if marker in path:
                rest = path.split(marker)[1]
                for kind in ('conv_', 'norm_'):
                    if rest.startswith(kind):
                        idx = int(rest[len(kind):].split('.')[0])
                        return idx < n
        return False
    return predicate
