"""A/B of one model's served clips/s between two checkouts, on one CUDA
card: ``chip_smoke.py``'s phase 3 (the shallow FBCRNN) and phase 5's
serving (the deep one).

    python3 scripts/serving_ab.py TREE_A TREE_B [--rounds 2]

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory,
and ``.``). The trees run in turns, A B B A (``--rounds`` pairs), each in a
process of its own that imports that tree's ``chip_smoke.py`` (and so its
``pb_sed_tpu_torch``), builds its kernels and runs ``phase_slice`` and
``phase_deep_serving`` with all their checks: tagging, boundaries
detection and SED at 51/1 and 250/250 of 3 x 32 ten-second clips by the
shallow model, 527-class tagging of them and 10-class SED 51/1 of one
batch by the deep one. The report gives per method every run's clips/s
(host clock, inference engine included, as the phases print it) and B / A
of the medians. The card's name and power limit come first.
"""
import argparse
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import ab

LINE = re.compile(r'^(\S+) (\S+): \d+ clips in [\d.]+ s = ([\d.]+) clips/s')
CHILD = ('import chip_smoke as c; c.phase_card(); c.phase_slice(); '
         'c.phase_deep_serving()')


def serve(tree):
    """{label method: clips/s} of one run in ``tree``; raises on a failed
    run."""
    run = subprocess.run([sys.executable, '-c', CHILD], cwd=tree,
                         capture_output=True, text=True, check=False)
    if run.returncode:
        raise RuntimeError(f'{tree} failed:\n{run.stdout[-2000:]}\n'
                           f'{run.stderr[-4000:]}')
    return {f'{m[1]} {m[2]}': float(m[3])
            for m in map(LINE.match, run.stdout.splitlines()) if m}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('tree_a', type=Path)
    parser.add_argument('tree_b', type=Path)
    parser.add_argument('--rounds', type=int, default=2)
    args = parser.parse_args()
    print(f'card: {ab.card()}', flush=True)
    runs = ab.alternate(args.tree_a, args.tree_b, args.rounds, serve)
    for side, rs in runs.items():
        print(f'{side}: {rs}', flush=True)
    for key in runs['A'][0]:
        a = [r[key] for r in runs['A']]
        b = [r[key] for r in runs['B']]
        print(f'{key}: A {a} B {b} clips/s; B / A of the medians '
              f'{np.median(b) / np.median(a):.3f}', flush=True)


if __name__ == '__main__':
    main()
