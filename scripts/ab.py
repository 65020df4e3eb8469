"""What the A/B drivers (``conv_ab.py``, ``gru_ab.py``, ``serving_ab.py``)
share: the card's name and power limit, the trees run in turns A B B A,
and a run of the driver itself inside a tree.

A driver calls :func:`alternate` with a function that measures one tree
(usually :func:`run_child`, which runs the driver with ``--time`` in a
process of its own whose working directory is the tree, so that it
imports that tree's ``pb_sed_tpu_torch`` and builds its kernels there).
"""
import json
import subprocess
import sys


def card():
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def alternate(tree_a, tree_b, rounds, measure):
    """``measure(tree)`` in turns A B B A, ``rounds`` times; returns
    {'A': [results], 'B': [results]}."""
    runs = {'A': [], 'B': []}
    for _ in range(rounds):
        for side in 'ABBA':
            tree = tree_a if side == 'A' else tree_b
            runs[side].append(measure(tree))
            print(f'timed {side} ({tree})', flush=True)
    return runs


def run_child(script, tree, tags, timeout=1500, args=()):
    """Run ``script --time`` (and ``args``) with ``tree`` as its working
    directory and return, per tag of ``tags``, the JSON of its last output
    line that starts with the tag and a space; raises on a failed run."""
    proc = subprocess.run([sys.executable, str(script), '--time', *args],
                          cwd=tree, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f'{tree}: rc {proc.returncode}\n'
                           f'{proc.stderr[-3000:]}')
    found = {}
    for tag in tags:
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(tag + ' ')]
        found[tag] = json.loads(lines[-1][len(tag) + 1:])
    return found
