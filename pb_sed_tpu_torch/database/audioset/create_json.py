"""Build ``audioset.json`` from downloaded AudioSet artifacts.

Capability parity with ``pb_sed/database/audioset/create_json.py:68-242``:
datasets {balanced_train, unbalanced_train, eval, train_strong,
eval_strong}; mid -> display-name mapping from the ontology; per-clip
mixed weak+strong ``label_types``; missing/damaged file reports; and the
full ontology with ancestor/descendant closure (``read_ontology``).

Input formats (public AudioSet distribution):
- segment CSVs ``YTID, start_seconds, end_seconds, positive_labels``
  (weak labels, mids, '#' comment headers),
- strong TSVs ``segment_id  start_time_seconds  end_time_seconds  label``,
- ``ontology.json``: list of {id, name, child_ids, ...}.

Usage: ``python -m pb_sed_tpu_torch.database.audioset.create_json -db /path``
"""
import argparse
import csv
import json
from pathlib import Path

from pb_sed_tpu_torch.database.helper import prepare_sound_dataset
from pb_sed_tpu_torch.paths import database_jsons_dir
from pb_sed_tpu_torch.utils.misc import dump_json


def read_ontology(ontology_file):
    """Ontology with ancestor/descendant closure.

    Returns ({name: {id, name, child_names, parent_names, ancestor_names,
    descendant_names, ...}}, {mid: name}).
    """
    with Path(ontology_file).open() as fid:
        nodes = json.load(fid)
    by_id = {node['id']: node for node in nodes}
    mid_to_name = {node['id']: node['name'] for node in nodes}
    parents = {node['id']: [] for node in nodes}
    for node in nodes:
        for child in node.get('child_ids', []):
            if child in parents:
                parents[child].append(node['id'])

    def ancestors(node_id, seen=None):
        seen = set() if seen is None else seen
        for p in parents[node_id]:
            if p not in seen:
                seen.add(p)
                ancestors(p, seen)
        return seen

    descendants_cache = {}

    def descendants(node_id):
        if node_id not in descendants_cache:
            out = set()
            for child in by_id[node_id].get('child_ids', []):
                if child in by_id:
                    out.add(child)
                    out |= descendants(child)
            descendants_cache[node_id] = out
        return descendants_cache[node_id]

    ontology = {}
    for node in nodes:
        nid = node['id']
        ontology[node['name']] = {
            'id': nid,
            'name': node['name'],
            'child_names': [
                mid_to_name[c] for c in node.get('child_ids', [])
                if c in mid_to_name],
            'parent_names': [mid_to_name[p] for p in parents[nid]],
            'ancestor_names': sorted(
                mid_to_name[a] for a in ancestors(nid)),
            'descendant_names': sorted(
                mid_to_name[d] for d in descendants(nid)),
            'restrictions': node.get('restrictions', []),
        }
    return ontology, mid_to_name


def read_segments_csv(filepath, mid_to_name):
    """Weak-label segments csv -> {clip_id: [event names]}."""
    out = {}
    with Path(filepath).open() as fid:
        for row in csv.reader(fid, skipinitialspace=True):
            if not row or row[0].startswith('#'):
                continue
            ytid, start, end, labels = row[0], row[1], row[2], row[3]
            names = [
                mid_to_name.get(mid.strip(), mid.strip())
                for mid in labels.strip('"').split(',') if mid.strip()]
            clip_id = f'Y{ytid}_{float(start):.0f}_{float(end):.0f}'
            out[clip_id] = sorted(set(names))
    return out


def read_strong_tsv(filepath, mid_to_name):
    """Strong-label tsv -> {clip_id: [(onset, offset, name)]}."""
    out = {}
    with Path(filepath).open() as fid:
        header = fid.readline()
        for line in fid:
            parts = line.rstrip('\n').split('\t')
            if len(parts) < 4:
                continue
            segment_id, onset, offset, mid = parts[:4]
            clip_id = segment_id.rsplit('_', 1)[0]
            out.setdefault(f'Y{clip_id}', []).append(
                (float(onset), float(offset),
                 mid_to_name.get(mid, mid)))
    return out


def build_dataset(clip_labels, audio_dir, strong=False):
    examples = {}
    for clip_id, labels in clip_labels.items():
        path = Path(audio_dir) / f'{clip_id}.wav'
        ex = {'audio_path': str(path)}
        if strong:
            labels = sorted(labels)
            ex['events'] = [lb for *_, lb in labels]
            ex['events_start_times'] = [on for on, *_ in labels]
            ex['events_stop_times'] = [off for _, off, _ in labels]
            ex['label_types'] = len(labels) * ['strong']
        else:
            ex['events'] = list(labels)
            ex['label_types'] = len(labels) * ['weak']
        examples[clip_id] = ex
    return examples


def construct_json(database_path):
    database_path = Path(database_path)
    ontology, mid_to_name = read_ontology(
        database_path / 'ontology.json')
    database = {'datasets': {}, 'ontology': ontology}
    weak_classes = set()
    strong_classes = set()
    reports = {}
    for name, csv_name in [
            ('balanced_train', 'balanced_train_segments.csv'),
            ('unbalanced_train', 'unbalanced_train_segments.csv'),
            ('eval', 'eval_segments.csv')]:
        csv_path = database_path / csv_name
        if not csv_path.exists():
            continue
        labels = read_segments_csv(csv_path, mid_to_name)
        examples = build_dataset(
            labels, database_path / 'audio' / name, strong=False)
        dataset, missing = prepare_sound_dataset(examples)
        database['datasets'][name] = dataset
        reports[name] = {'missing': sorted(missing),
                         'total': len(labels)}
        for ex in dataset.values():
            weak_classes.update(ex['events'])
        print(f'{name}: {len(dataset)} clips '
              f'({len(missing)} missing/damaged)')
    for name, tsv_name in [
            ('train_strong', 'audioset_train_strong.tsv'),
            ('eval_strong', 'audioset_eval_strong.tsv')]:
        tsv_path = database_path / tsv_name
        if not tsv_path.exists():
            continue
        events = read_strong_tsv(tsv_path, mid_to_name)
        examples = build_dataset(
            events, database_path / 'audio' / name, strong=True)
        dataset, missing = prepare_sound_dataset(examples)
        database['datasets'][name] = dataset
        reports[name] = {'missing': sorted(missing),
                         'total': len(events)}
        for ex in dataset.values():
            strong_classes.update(ex['events'])
        print(f'{name}: {len(dataset)} clips '
              f'({len(missing)} missing/damaged)')
    database['weak_event_classes'] = sorted(weak_classes)
    database['strong_event_classes'] = sorted(strong_classes)
    return database, reports


def create_jsons(database_path, json_path, indent=2):
    database, reports = construct_json(database_path)
    json_path = Path(json_path)
    dump_json(database, json_path / 'audioset.json', indent=indent)
    dump_json(reports, json_path / 'audioset_missing_files.json',
              indent=indent)
    print(f'Dumped json {json_path / "audioset.json"}')


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--database-path', '-db', required=True)
    parser.add_argument('--json-path', '-j',
                        default=str(database_jsons_dir))
    args = parser.parse_args()
    create_jsons(Path(args.database_path).absolute(),
                 Path(args.json_path).absolute())


if __name__ == '__main__':
    main()
