"""Tag-conditioned BiCRNN training experiment.

Counterpart of ``pb_sed_tpu/experiments/strong_label_crnn/training.py``,
with the same config and recipes: the BiCRNN recipe on a pseudo-labeled
DESED json (with or without external data, ``train_unlabel_in_domain=2``,
60000*16/bs iterations, decay at 30000*16/bs, ramp 1000) or on AudioSet
``train_strong`` (456 classes, ``eval_segment_length`` 50, clipping 0.1,
no conditioning); the weak targets are mapped onto ``tag_condition`` for
the training and validation batches; validation on
``macro_fscore_strong``; CNN-only init surgery; layer freezing; the
chain into the strong tuning experiment.

The run trains on the CUDA card (``device=None``); ``device=cpu`` runs it
on the CPU, and without a card and without that request it raises. The
init checkpoint is read with ``utils.checkpoint.load_payload``, so it may
be one that either package's ``Trainer`` wrote. With
``validation_set_name`` set (the DESED default) training chains into the
tuning experiment on that set (it needs ``weak_label_crnn_hyper_params_dir``,
the weak tuning run whose ensemble tags the clips), and tuning into
inference on ``eval_set_name``. One difference: the chain passes its
``device`` on, so tuning and inference restore the models where the
training ran (the JAX chain passes none).

Run: ``python -m pb_sed_tpu_torch.experiments.strong_label_crnn.training
with weak_label_crnn_hyper_params_dir=<weak tuning dir> ...``
"""
import time

from pb_sed_tpu_torch.data.provider import DataProvider
from pb_sed_tpu_torch.database.audioset.provider import AudioSetProvider
from pb_sed_tpu_torch.database.desed.provider import DESEDProvider
from pb_sed_tpu_torch.experiments.core import (
    Experiment, FileStorageObserver, print_config)
from pb_sed_tpu_torch.experiments.weak_label_crnn.training import (
    make_cnn_freeze_predicate)
from pb_sed_tpu_torch.models import strong_label
from pb_sed_tpu_torch.models.base.model import default_device
from pb_sed_tpu_torch.models.net_configs import (
    cnn_config, feature_extractor_config, rnn_config)
from pb_sed_tpu_torch.paths import database_jsons_dir, storage_root
from pb_sed_tpu_torch.train.hooks import LRAnnealingHook
from pb_sed_tpu_torch.train.optimizer import Adam
from pb_sed_tpu_torch.train.trainer import Trainer
from pb_sed_tpu_torch.utils.checkpoint import load_payload
from pb_sed_tpu_torch.utils.misc import timestamp

ex_name = 'strong_label_crnn_training'
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
        storage_root / 'strong_label_crnn' / database_name / 'training'
        / cfg['group_name'] / cfg['timestamp'])
    storage_dir = cfg['storage_dir']
    cfg['resume'] = False

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
            'json_path': str(
                database_jsons_dir
                / ('desed_pseudo_labeled_with_external.json'
                   if external_data
                   else 'desed_pseudo_labeled_without_external.json')),
            'train_set': {
                'train_weak': 10 if external_data else 20,
                'train_strong': 10 if external_data else 0,
                'train_synthetic20': 2,
                'train_synthetic21': 1,
                'train_unlabel_in_domain': 2,
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
            'train_transform': {'provide_strong_targets': True},
            'storage_dir': storage_dir,
        }
        cfg['num_events'] = 10
        DESEDProvider.get_config(cfg['data_provider'])
        cfg['validation_set_name'] = 'validation'
        cfg['validation_ground_truth_filepath'] = None
        cfg['eval_set_name'] = 'eval_public'
        cfg['eval_ground_truth_filepath'] = None
        cfg['weak_label_crnn_hyper_params_dir'] = ''
        cfg['num_iterations'] = int(60000 * 16 / batch_size)
        cfg['checkpoint_interval'] = int(2000 * 16 / batch_size)
        cfg['summary_interval'] = 100
        cfg['lr'] = 5e-4
        cfg['n_back_off'] = 0
        cfg['back_off_patience'] = 10
        cfg['lr_decay_steps'] = [
            int(30000 * 16 / batch_size)
        ] if cfg['n_back_off'] == 0 else []
        cfg['lr_decay_factor'] = 1 / 5
        cfg['lr_rampup_steps'] = None if finetune_mode else 1000
        cfg['early_stopping_patience'] = None
        cfg['gradient_clipping'] = 1 if finetune_mode else 1e10
        cfg['eval_segment_length'] = 1
        cfg['tag_conditioning'] = True
    elif database_name == 'audioset':
        cfg['batch_size'] = 32
        batch_size = cfg['batch_size']
        cfg['data_provider'] = {
            'factory': AudioSetProvider,
            'train_set': {'train_strong': 1},
            'train_fetcher': {
                'batch_size': batch_size,
                'prefetch_workers': 2,
            },
            'train_transform': {'provide_strong_targets': True},
            'min_class_examples_per_epoch': 0.01,
            'storage_dir': storage_dir,
        }
        cfg['num_events'] = 456
        AudioSetProvider.get_config(cfg['data_provider'])
        cfg['validation_set_name'] = None
        cfg['validation_ground_truth_filepath'] = None
        cfg['eval_set_name'] = None
        cfg['eval_ground_truth_filepath'] = None
        cfg['weak_label_crnn_hyper_params_dir'] = ''
        cfg['num_iterations'] = int(200000 * 16 / batch_size)
        cfg['checkpoint_interval'] = int(10000 * 16 / batch_size)
        cfg['summary_interval'] = int(1000 * 16 / batch_size)
        cfg['lr'] = 1e-4
        cfg['n_back_off'] = 0
        cfg['back_off_patience'] = 10
        cfg['lr_decay_steps'] = [int(100000 * 16 / batch_size)]
        cfg['lr_decay_factor'] = 1 / 5
        cfg['lr_rampup_steps'] = int(2000 * 16 / batch_size)
        cfg['early_stopping_patience'] = None
        cfg['gradient_clipping'] = .1
        cfg['eval_segment_length'] = 50
        cfg['tag_conditioning'] = False
    else:
        raise ValueError(f'Unknown database {database_name}.')
    cfg['hyper_params_tuning_batch_size'] = cfg['batch_size'] // 2

    cfg['net_config'] = 'shallow'
    width, cnn = cnn_config(cfg['net_config'], cfg['num_events'])
    # reference depth: 2 bidirectional GRU layers
    # (``strong_label_crnn/training.py:245-250``)
    rnn = rnn_config(width, cfg['num_events'], num_layers=2)
    rnn['rnn']['bidirectional'] = True
    cfg['trainer'] = {
        'factory': Trainer,
        'model': {
            'factory': strong_label.CRNN,
            'feature_extractor': feature_extractor_config(
                sample_rate=16000, stft_size=1024,
                number_of_filters=128, augment=True),
            'cnn': cnn,
            'rnn': rnn,
            'tag_conditioning': cfg['tag_conditioning'],
            'eval_segment_length': cfg['eval_segment_length'],
            'labelwise_metrics': ['fscore_strong'],
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


def add_tag_condition(batch):
    """The weak targets as the conditioning input."""
    batch['tag_condition'] = batch['weak_targets']
    return batch


@ex.automain
def train(_config, debug, resume, delay, data_provider, trainer,
          lr_rampup_steps, n_back_off, back_off_patience, lr_decay_steps,
          lr_decay_factor, early_stopping_patience, init_ckpt_path,
          frozen_cnn_2d_layers, frozen_cnn_1d_layers, freeze_norm_stats,
          validation_set_name, validation_ground_truth_filepath,
          weak_label_crnn_hyper_params_dir, eval_set_name,
          eval_ground_truth_filepath, device, track_emissions,
          hyper_params_tuning_batch_size):
    print('\n##### Training #####\n')
    print_config(_config)
    assert (n_back_off == 0) or (len(lr_decay_steps) == 0), (
        n_back_off, lr_decay_steps)
    if delay > 0:
        print(f'Sleep for {delay} seconds.')
        time.sleep(delay)
    placed = default_device(device)

    data_provider = DataProvider.from_config(data_provider)
    label_init_names = [
        key for key, reps in data_provider.train_set.items() if reps > 0]
    if validation_set_name is not None:
        label_init_names.append(validation_set_name)
    data_provider.train_transform.label_encoder.initialize_labels(
        dataset=data_provider.db.get_dataset(label_init_names),
        verbose=True)
    data_provider.test_transform.label_encoder.initialize_labels()
    trainer = Trainer.from_config(trainer)
    trainer.model.to(placed)
    trainer.model.label_mapping = []
    encoder = data_provider.train_transform.label_encoder
    for idx, label in sorted(encoder.inverse_label_mapping.items()):
        assert idx == len(trainer.model.label_mapping), (idx, label)
        trainer.model.label_mapping.append(
            label.replace(', ', '__').replace(' ', '').replace('(', '_')
            .replace(')', '_').replace("'", ''))

    train_set = data_provider.get_train_set().map(add_tag_condition)
    validate_set = data_provider.get_validate_set()
    if validate_set is not None:
        validate_set = validate_set.map(add_tag_condition)

    # initialize the weights, then do the init-checkpoint surgery
    trainer._ensure_ready()
    print('Params', trainer.model.num_parameters())

    if init_ckpt_path is not None:
        print('Load init params (cnn only)')
        # load_payload reads either package's checkpoints (a JAX run's
        # optimizer state needs no optax)
        flat = load_payload(init_ckpt_path)['model']
        cnn_only = {k: v for k, v in flat.items() if '.cnn.' in k}
        trainer.model.load_partial_state_dict(cnn_only)
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
            validate_set, metric='macro_fscore_strong', maximize=True,
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
        trainer.register_hook(
            LRAnnealingHook(breakpoints=breakpoints, unit='iteration'))

    trainer.train(train_set, resume=resume, device=placed,
                  track_emissions=track_emissions)

    if validation_set_name:
        from pb_sed_tpu_torch.experiments.strong_label_crnn.tuning import (
            ex as tuning)
        tuning.run(config_updates={
            'debug': debug,
            'weak_label_crnn_hyper_params_dir':
                weak_label_crnn_hyper_params_dir,
            'strong_label_crnn_dirs': [str(trainer.storage_dir)],
            'validation_set_name': validation_set_name,
            'validation_ground_truth_filepath':
                validation_ground_truth_filepath,
            'eval_set_name': eval_set_name,
            'eval_ground_truth_filepath': eval_ground_truth_filepath,
            'data_provider': {
                'test_fetcher': {
                    'batch_size': hyper_params_tuning_batch_size,
                },
            },
            'device': device,
        })
    return str(trainer.storage_dir)
