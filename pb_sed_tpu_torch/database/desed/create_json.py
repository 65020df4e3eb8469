"""Build ``desed.json`` (+ pseudo-labeled variants) from a DESED corpus
tree.

Capability parity with ``pb_sed/database/desed/create_json.py:31-212``:
the 10 DESED target event classes; per-clip dicts with ``audio_path`` /
``audio_length`` plus ``events`` (+ ``events_{start,stop}_times`` for
strongly labeled sets); strong labels for synthetic / validation /
eval_public / train_strong, weak labels for train_weak, none for
unlabel_in_domain; and merging of shipped strong pseudo-label TSVs into
``train_weak`` / ``train_unlabel_in_domain`` to produce the
``desed_pseudo_labeled_{without,with}_external.json`` variants.

Usage:
``python -m pb_sed_tpu_torch.database.desed.create_json -db /path/to/desed``
"""
import argparse
import csv
from copy import deepcopy
from pathlib import Path

from pb_sed_tpu_torch.database.helper import prepare_sound_dataset
from pb_sed_tpu_torch.evaluation.scores import (
    read_ground_truth_events, read_ground_truth_tags)
from pb_sed_tpu_torch.paths import database_jsons_dir, repo_dir
from pb_sed_tpu_torch.utils.misc import dump_json

target_events = [
    'Alarm_bell_ringing',
    'Blender',
    'Cat',
    'Dishes',
    'Dog',
    'Electric_shaver_toothbrush',
    'Frying',
    'Running_water',
    'Speech',
    'Vacuum_cleaner',
]


def read_ground_truth_file(filepath):
    with Path(filepath).open(newline='') as fid:
        columns = next(csv.reader(fid, delimiter='\t'), [])
    if 'onset' in columns:
        return read_ground_truth_events(filepath)
    return read_ground_truth_tags(filepath)[0]


def add_strong_labels(examples, ground_truth):
    for clip_id in examples:
        event_list = ground_truth.get(clip_id, [])
        if event_list:
            assert isinstance(event_list[0], (list, tuple)), event_list
            event_list = [
                ev for ev in event_list if ev[2] in target_events]
        if event_list:
            onsets, offsets, labels = zip(*event_list)
        else:
            onsets, offsets, labels = [], [], []
        examples[clip_id]['events_start_times'] = list(onsets)
        examples[clip_id]['events_stop_times'] = list(offsets)
        examples[clip_id]['events'] = list(labels)
    return examples


def add_weak_labels(examples, ground_truth):
    for clip_id in examples:
        labels = ground_truth.get(clip_id, [])
        if labels and isinstance(labels[0], (list, tuple)):
            labels = [ev[2] for ev in labels]
        examples[clip_id]['events'] = [
            label for label in labels if label in target_events]
    return examples


def construct_json(database_path):
    database_path = Path(database_path)
    database = {'datasets': {}}
    for purpose in ['train', 'validation', 'eval']:
        audio_base_dir = database_path / 'audio' / purpose
        if not audio_base_dir.is_dir():
            continue
        for subdir in sorted(audio_base_dir.iterdir()):
            if not subdir.is_dir():
                continue
            name = subdir.name
            dataset_name = purpose if name == purpose else \
                f'{purpose}_{name}'
            ground_truth_file = (
                database_path / 'metadata' / purpose / f'{name}.tsv')
            if ground_truth_file.exists() and name != 'unlabel_in_domain':
                ground_truth = read_ground_truth_file(ground_truth_file)
                clip_ids = list(ground_truth.keys())
            else:
                ground_truth = None
                clip_ids = sorted(
                    p.stem for p in subdir.glob('*.wav'))
            examples = {
                clip_id: {'audio_path': str(subdir / f'{clip_id}.wav')}
                for clip_id in sorted(clip_ids)
            }
            if 'synthetic' in name or dataset_name in (
                    'validation', 'eval_public', 'train_strong'):
                assert ground_truth is not None, dataset_name
                add_strong_labels(examples, ground_truth)
            elif ground_truth:
                assert dataset_name == 'train_weak', dataset_name
                add_weak_labels(examples, ground_truth)
            dataset, missing = prepare_sound_dataset(examples)
            database['datasets'][dataset_name] = dataset
            print(f'{len(missing)} of {len(clip_ids)} files missing in '
                  f'{dataset_name}')
            labels = {
                ev for ex in dataset.values()
                for ev in ex.get('events', [])}
            print(f'Number of event labels in {dataset_name}:',
                  len(labels))
    return database


def create_jsons(database_path, json_path, pseudo_label_dirs=None,
                 indent=2):
    database_path = Path(database_path)
    json_path = Path(json_path)
    assert database_path.is_dir(), database_path
    database = construct_json(database_path)
    dump_json(database, json_path / 'desed.json', indent=indent)
    print(f'Dumped json {json_path / "desed.json"}')
    if pseudo_label_dirs is None:
        exp_root = repo_dir / 'exp' / 'strong_label_crnn_inference'
        pseudo_label_dirs = {
            'without_external': exp_root / '2022-05-04-09-05-53',
            'with_external': exp_root / '2022-06-24-10-06-21',
        }
    for tag, pl_dir in pseudo_label_dirs.items():
        pl_dir = Path(pl_dir)
        if not pl_dir.is_dir():
            print(f'No pseudo-label dir {pl_dir}; skipping {tag} variant')
            continue
        variant = deepcopy(database)
        for ds_name in ['train_weak', 'train_unlabel_in_domain']:
            tsv = pl_dir / f'{ds_name}_pseudo_labeled.tsv'
            if tsv.exists() and ds_name in variant['datasets']:
                add_strong_labels(
                    variant['datasets'][ds_name],
                    read_ground_truth_file(tsv))
        out = json_path / f'desed_pseudo_labeled_{tag}.json'
        dump_json(variant, out, indent=indent)
        print(f'Dumped json {out}')


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--database-path', '-db', required=True,
                        help='Path where the database is located.')
    parser.add_argument('--json-path', '-j',
                        default=str(database_jsons_dir),
                        help='Output directory for the json files.')
    args = parser.parse_args()
    create_jsons(Path(args.database_path).absolute(),
                 Path(args.json_path).absolute())


if __name__ == '__main__':
    main()
