"""The port's strong-label experiments through their entry points on the
CPU (``device=cpu``), on the synthetic database of ``tests/util_synth.py``:
``experiments.strong_label_crnn.training`` trains a tiny tag-conditioned
BiCRNN for 4 iterations (batch 4, validation every 2) and chains into
tuning (the debug median filter, 31) and inference on ``eval_public``;
then an inference run pseudo-labels ``train_unlabel_in_domain`` strongly
(database json and TSV) and one runs in overlapping segments. The weak
side they need (the ensemble that tags the clips) is a 2-iteration run of
the weak training experiment and a tuning directory that names it, with
its tagging thresholds. The best strong checkpoint scores the frames of
one batch as the JAX package's strong model does on the same weights and
tags; the recipes' configs equal the JAX experiment's; and the run
refuses to start without a card unless ``device='cpu'``.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.models import strong_label as jstrong
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu_torch.experiments.strong_label_crnn import (inference,
                                                           training, tuning)
from pb_sed_tpu_torch.experiments.weak_label_crnn import (
    training as weak_training)
from pb_sed_tpu_torch.utils.checkpoint import load_payload
from pb_sed_tpu_torch.utils.misc import dump_json
from tests.test_torch_cli import TS, _updates
from tests.util_synth import build_database

torch.set_num_threads(2)

CLASSES = ['beep', 'chirp', 'hum']
STRONG_MODEL = {
    'feature_extractor': {
        'stft_size': 512, 'stft_shift': 160, 'stft_window_length': 480,
        'number_of_filters': 16, 'n_time_masks': 1, 'n_frequency_masks': 1,
        'max_noise_scale': .1,
    },
    'cnn': {
        'cnn_2d': {'out_channels': [16, 16], 'pool_size': [[2, 1], [2, 1]],
                   'kernel_size': 3},
        'cnn_1d': {'out_channels': [8, 8], 'kernel_size': 3},
    },
    'rnn': {
        'rnn': {'hidden_size': 8, 'num_layers': 2},
        'output_net': {'out_channels': [8, 3], 'kernel_size': 1},
    },
}


def weak_hyper_params_dir(root, json_path, device='cpu'):
    """A weak ensemble of one member for the strong experiments: 2
    iterations of the weak training experiment (the tiny model of
    ``tests/test_torch_cli.py``) and a tuning directory that names it
    (``1/config.json``) with tagging thresholds of .5. Returns the
    directory."""
    weak_dir = root / 'weak' / TS / TS
    weak_training.ex.run(config_updates=_updates(
        json_path, weak_dir, num_iterations=2, checkpoint_interval=2,
        device=device))
    hp_dir = root / 'weak_hyper_params'
    dump_json({'crnn_dirs': [str(weak_dir)],
               'crnn_checkpoints': 'ckpt_latest.pkl'},
              hp_dir / '1' / 'config.json')
    dump_json({c: {'threshold': .5, 'medfilt_length': 1} for c in CLASSES},
              hp_dir / 'tagging_hyper_params_f.json')
    return hp_dir


def strong_updates(json_path, storage_dir, weak_hp_dir, **more):
    """The weak CLI test's updates for the strong experiment: the tiny
    tag-conditioned BiCRNN, strong targets from the loader."""
    updates = _updates(json_path, storage_dir, checkpoint_interval=2,
                       num_iterations=4)
    updates['trainer'] = {'model': copy.deepcopy(STRONG_MODEL)}
    updates['data_provider']['train_transform'].update(
        provide_strong_targets=True, provide_boundary_targets=False)
    updates.update(weak_label_crnn_hyper_params_dir=str(weak_hp_dir),
                   tag_conditioning=True)
    updates.update(more)
    return updates


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
    """The strong run chained into tuning and inference; returns the
    database json, the weak tuning directory, the strong run directory
    and the storage root of tuning and inference."""
    root = tmp_path_factory.mktemp('strong_cli')
    _, json_path = build_database(root / 'db', num_train=8, num_weak=6,
                                  num_validate=4)
    weak_hp_dir = weak_hyper_params_dir(root, json_path)
    storage_root = root / 'exp'
    saved = tuning.storage_root, inference.storage_root
    tuning.storage_root = inference.storage_root = storage_root
    try:
        run_dir = root / 'strong' / TS / TS
        updates = strong_updates(json_path, run_dir, weak_hp_dir)
        del updates['validation_set_name']
        assert training.ex.run(config_updates=updates) == str(run_dir)
    finally:
        tuning.storage_root, inference.storage_root = saved
    return json_path, weak_hp_dir, run_dir, storage_root


def _rows(storage_dir):
    return [json.loads(line) for line in
            (storage_dir / 'summary.jsonl').read_text().splitlines()]


def test_strong_run_writes_the_run_directory(chain):
    _, _, run_dir, _ = chain
    config = json.loads((run_dir / '1' / 'config.json').read_text())
    model = config['trainer']['model']
    assert model['factory'] == 'pb_sed_tpu_torch.models.strong_label.crnn.CRNN'
    assert model['tag_conditioning'] is True
    assert model['cnn']['conditional_dims'] == 3
    assert model['rnn']['rnn']['bidirectional'] is True
    assert model['rnn']['rnn']['input_size'] == 8 + 3
    assert config['device'] == 'cpu'
    names = sorted(p.name for p in (run_dir / 'checkpoints').iterdir())
    assert names == ['ckpt_4.pkl', 'ckpt_best_macro_fscore_strong.pkl',
                     'ckpt_latest.pkl']
    rows = _rows(run_dir)
    assert [(r['prefix'], r['iteration']) for r in rows] == [
        ('training', 2), ('validation', 2), ('training', 4),
        ('validation', 4), ('validation', 4)]
    for row in rows:
        for key in ('loss', 'macro_fscore_strong', 'lwlrap_strong',
                    'z/fscore_strong/beep'):
            assert np.isfinite(row[key]), (row['prefix'], key)
        assert row['num_examples_strong'] > 0
    assert 0. < rows[0]['strong_label_rate'] <= 1.
    payload = load_payload(run_dir / 'checkpoints' / 'ckpt_latest.pkl')
    assert payload['iteration'] == 4 and payload['optimizer']['count'] == 4


def test_chain_tunes_and_runs_inference(chain):
    """Tuning (the debug median filter) writes the three hyper-parameter
    files with each class's keys, every threshold in [0, 1] or at an end
    of its sweep, links itself into the run directory and chains into
    inference on ``eval_public`` with the sets f and psds1: finite
    results, PSDS and F-scores in [0, 1]."""
    _, weak_hp_dir, run_dir, storage_root = chain
    root = storage_root / 'strong_label_crnn' / 'desed'
    (hp_dir,) = (root / 'hyper_params').iterdir()
    config = json.loads((hp_dir / '1' / 'config.json').read_text())
    assert config['device'] == 'cpu' and config['medfilt_lengths'] == [31]
    assert config['weak_label_crnn_dirs'] == json.loads(
        (weak_hp_dir / '1' / 'config.json').read_text())['crnn_dirs']
    assert config['data_provider']['test_fetcher']['batch_size'] == 4
    keys = {'f': ['f', 'medfilt_length', 'offset_bias', 'onset_bias',
                  'tag_masked', 'threshold'],
            'psds1': ['auc1', 'medfilt_length', 'tag_masked', 'threshold'],
            'psds2': ['auc2', 'medfilt_length', 'tag_masked', 'threshold']}
    for name, expected in keys.items():
        params = json.loads(
            (hp_dir / f'sed_hyper_params_{name}.json').read_text())
        assert sorted(params) == CLASSES
        for values in params.values():
            assert sorted(values) == expected, name
            assert values['medfilt_length'] == 31
            # or an end of the collar sweep: 1e-3 beyond the lowest or
            # highest score (every frame detected, or none), or +-inf
            assert (-1e-3 <= values['threshold'] <= 1. + 1e-3
                    or abs(values['threshold']) == np.inf), name
    assert (run_dir / 'hyper_params' / hp_dir.name).resolve() == hp_dir
    (out_dir,) = (root / 'inference').iterdir()
    assert [p.resolve() for p in (hp_dir / 'inference').iterdir()] == [
        out_dir]
    results = {p.name: json.loads(p.read_text())
               for p in out_dir.glob('*_results_*.json')}
    assert sorted(results) == ['sed_f_results_eval_public.json',
                               'sed_psds1_results_eval_public.json']
    for name, values in results.items():
        assert values and all(np.isfinite(v) for v in values.values()), name
        for key in ('psds[0]', 'psds[1]', 'macro_average_f'):
            assert 0. <= values[key] <= 1. + 1e-12, (name, key)
    for c in CLASSES:
        assert {f'{c}_onset_bias', f'{c}_offset_bias', f'{c}_auc[0]'} <= set(
            results['sed_f_results_eval_public.json']), c


def test_inference_pseudo_labels_strongly(chain, tmp_path):
    """An inference run on ``train_weak`` with the set f writes the score
    and detection files, a database json whose clips carry strong
    pseudo-labels for their tags (detected events, the whole clip for a
    tag without one), and ``train_weak_pseudo_labeled.tsv`` (a row per
    event, an empty row for a clip without one). The strong pass keeps a
    clip's tags, so the set must carry tags: the JAX experiment's
    ``pseudo_label(..., pseudo_tags=False, ...)``."""
    json_path, _, _, storage_root = chain
    (hp_dir,) = (storage_root / 'strong_label_crnn' / 'desed'
                 / 'hyper_params').iterdir()
    out_dir = tmp_path / 'pseudo'
    result = inference.ex.run(config_updates={
        'debug': True, 'device': 'cpu',
        'strong_label_crnn_hyper_params_dir': str(hp_dir),
        'storage_dir': str(out_dir), 'sed_hyper_params_name': 'f',
        'dataset_name': ['train_weak'], 'strong_pseudo_labeling': [True],
        'save_scores': True, 'save_detections': True})
    assert result == str(out_dir)
    source = json.loads(json_path.read_text())['datasets']['train_weak']
    database = json.loads((out_dir / json_path.name).read_text())
    clips = database['datasets']['train_weak']
    assert sorted(clips) == sorted(source)
    for clip, example in clips.items():
        n = len(example['events'])
        assert set(example['events']) == set(source[clip]['events'])
        assert len(example['events_start_times']) == n
        assert len(example['events_stop_times']) == n
        assert len(example['label_types']) == n
        assert set(example['label_types']) <= {'strong', 'weak'}
    lines = (out_dir / 'train_weak_pseudo_labeled.tsv'
             ).read_text().splitlines()
    assert lines[0] == 'filename\tonset\toffset\tevent_label'
    assert {line.split('\t')[0] for line in lines[1:]} == {
        f'{clip}.wav' for clip in clips}
    scores = sorted((out_dir / 'scores' / 'train_weak' / 'f').iterdir())
    assert len(scores) == len(clips)
    assert (out_dir / 'detections' / 'train_weak' / 'f'
            / 'cbf.tsv').exists()


def test_segmented_inference_merges_the_clips(chain, tmp_path):
    """With ``max_segment_length`` (frames) shorter than the clips, the
    weak and strong models run on overlapping segments (``_!segment!_``
    ids), the tags and the scores are keyed back to the clip ids, and the
    results are finite."""
    _, _, _, storage_root = chain
    (hp_dir,) = (storage_root / 'strong_label_crnn' / 'desed'
                 / 'hyper_params').iterdir()
    out_dir = tmp_path / 'segments'
    inference.ex.run(config_updates={
        'debug': True, 'device': 'cpu',
        'strong_label_crnn_hyper_params_dir': str(hp_dir),
        'storage_dir': str(out_dir), 'sed_hyper_params_name': 'psds2',
        'max_segment_length': 30, 'segment_overlap': 10})
    values = json.loads(
        (out_dir / 'sed_psds2_results_eval_public.json').read_text())
    assert values and all(np.isfinite(v) for v in values.values())


def test_best_checkpoint_scores_frames_as_jax_does(chain):
    """The best strong checkpoint, restored by the port with
    ``from_storage_dir`` and by the JAX package's model of the run's
    config, scores one validation batch, conditioned on the weak
    ensemble's tags (0/1 floats, by example id), alike within
    ``1e-4 + 3e-2 * max|ref|``."""
    from pb_sed_tpu_torch.data.provider import DataProvider
    from pb_sed_tpu_torch.experiments.weak_label_crnn.inference import (
        tagging)
    from pb_sed_tpu_torch.models import strong_label, weak_label
    _, weak_hp_dir, run_dir, _ = chain
    config = json.loads((run_dir / '1' / 'config.json').read_text())
    provider = DataProvider.from_config(config['data_provider'])
    provider.test_transform.label_encoder.initialize_labels()
    batch = next(iter(provider.get_dataset('validation')))
    weak_config = json.loads((weak_hp_dir / '1' / 'config.json').read_text())
    weak = [weak_label.CRNN.from_storage_dir(
        d, checkpoint_name='ckpt_latest.pkl', device='cpu')
        for d in weak_config['crnn_dirs']]
    tags, _, _ = tagging(weak, [batch], None, CLASSES, weak_hp_dir, None,
                         None)
    batch = {k: v for k, v in batch.items()
             if k in ('audio_data', 'seq_len', 'example_id')}
    batch['tag_condition'] = np.array(
        [tags[i] for i in batch['example_id']]).astype(np.float32)
    port = strong_label.CRNN.from_storage_dir(
        run_dir, checkpoint_name='ckpt_best_macro_fscore_strong.pkl',
        device='cpu')
    got, got_len = port.sound_event_detection(batch)
    text = (run_dir / '1' / 'config.json').read_text().replace(
        '"pb_sed_tpu_torch.', '"pb_sed_tpu.')
    jmodel = jstrong.CRNN.from_config(json.loads(text)['trainer']['model'])
    arrays = {k: jnp.asarray(v) for k, v in batch.items()
              if k != 'example_id'}
    jrnn.set_pallas_mode('off')
    try:
        jmodel.variables = jax.jit(lambda b: jmodel.module.init(
            {'params': jax.random.PRNGKey(0)}, b, training=False))(arrays)
        flat = load_payload(run_dir / 'checkpoints'
                            / 'ckpt_best_macro_fscore_strong.pkl')['model']
        assert sorted(jmodel.state_dict()) == sorted(flat)
        jmodel.load_state_dict(flat)
        ref, ref_len = jmodel.sound_event_detection(arrays)
    finally:
        jrnn.set_pallas_mode('auto')
    np.testing.assert_array_equal(got_len, ref_len)
    assert got.shape == ref.shape and got.shape[:2] == (4, 3)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 + 3e-2 * float(np.abs(ref).max()))


def test_strong_cli_defaults_to_the_card(chain, tmp_path):
    """``device=None`` means the card: without one the run raises before
    it builds anything, naming ``device='cpu'``."""
    json_path, weak_hp_dir, _, _ = chain
    updates = strong_updates(json_path, tmp_path / TS / TS, weak_hp_dir)
    del updates['device']
    if torch.cuda.is_available():
        pytest.skip('a card is there: the default device is valid')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.ex.run(config_updates=updates)
    assert not (tmp_path / TS / TS / 'checkpoints').exists()


def test_strong_recipe_equals_the_jax_experiment():
    """The DESED config gives what the JAX experiment's gives, value for
    value, once the factories' package is set aside."""
    from pb_sed_tpu.experiments.strong_label_crnn import (
        training as jtraining)
    from pb_sed_tpu.utils.config import config_to_json as jax_to_json
    from pb_sed_tpu_torch.utils.config import config_to_json
    updates = {'database_name': 'desed', 'timestamp': TS}
    got = config_to_json(dict(training.ex.build_config(dict(updates))))
    ref = jax_to_json(dict(jtraining.ex.build_config(dict(updates))))
    expected = dict(num_events=10, num_iterations=30000, lr=5e-4,
                    checkpoint_interval=1000, lr_decay_steps=[15000],
                    lr_rampup_steps=1000, gradient_clipping=1e10,
                    eval_segment_length=1, tag_conditioning=True,
                    validation_set_name='validation')
    for key, value in expected.items():
        assert got[key] == value, key
    model = got['trainer']['model']
    assert model['rnn']['rnn']['bidirectional'] is True
    assert model['rnn']['rnn']['num_layers'] == 2
    assert got['data_provider']['train_set']['train_unlabel_in_domain'] == 2

    def ported(node):
        if isinstance(node, dict):
            return {k: ported(v) for k, v in node.items()}
        if isinstance(node, list):
            return [ported(v) for v in node]
        if isinstance(node, str) and node.startswith('pb_sed_tpu.'):
            return 'pb_sed_tpu_torch.' + node[len('pb_sed_tpu.'):]
        return node

    assert got == ported(ref)


def test_audioset_recipe_fails_as_the_jax_one_does():
    """The AudioSet strong recipe's config does not build in either
    package: its provider adds the weak ``eval`` set as the validation
    set beside ``train_strong``, which ``strongly_labeled_data`` refuses
    (the JAX package's own fault, kept; the port runs that model
    configuration on in-memory batches)."""
    from pb_sed_tpu.experiments.strong_label_crnn import (
        training as jtraining)
    updates = {'database_name': 'audioset', 'timestamp': TS}
    for experiment in (training.ex, jtraining.ex):
        with pytest.raises(AssertionError):
            experiment.build_config(dict(updates))
