"""Phase 13a's rounding-noise probe at several seeds, on one CUDA card.

    python3 scripts/perf/mesh_noise_seeds.py [TREE ...] [--seeds 5]

For each tree (a checkout of this repository; the working directory when
none is given), a process of its own with that tree's ``chip_smoke.py``
and package: the full-width shallow FBCRNN's 4 steps in one process and
in a world of 2 gloo ranks on the card (``chip_smoke.phase_mesh``'s 13a),
then the one process's steps again with every global sum and gradient
moved by one ulp (``_RoundingProbe``) at each seed of the signs, and
``_check_mesh_steps`` on the mesh against that single probe: per seed the
verdict, the deviation and the probe's noise of a few parameters, and
the worst quantity's share of its bound. It shows how far one probe's
noise estimate, and with it the rule's verdict, moves with its seed.
A tree whose ``_mesh_training`` still takes ``probe=True`` (one seed-0
generator) gets its seed through ``_PROBE_GENERATOR``.
"""
import argparse
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

KEYS = ('params.cnn.cnn_2d.norm_1.scale', 'params.cnn.cnn_2d.conv_0.kernel',
        'params.cnn.cnn_2d.norm_2.shift', 'params.cnn.cnn_2d.norm_7.scale')


def run_tree(seeds):
    """Inside a tree: print one line ``NOISE ...`` per seed."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from pb_sed_tpu_torch.parallel.launch import run_ranks
    cs.phase_card()
    config, flat, batches, _ = cs._mesh_data()
    ref = cs._mesh_training(config, flat, batches)
    ref['p0'] = flat
    ranks = run_ranks(cs.mesh_rank, cs.MESH_WORLD, backend='gloo',
                      timeout_s=cs.MESH_TIMEOUT_S)
    module = cs._model(config, flat).module
    seeded = inspect.signature(cs._mesh_training).parameters[
        'probe'].default is None
    for seed in range(seeds):
        if seeded:
            probe = cs._mesh_training(config, flat, batches, probe=seed)
            arg = [probe]
        else:
            cs._PROBE_GENERATOR.clear()
            cs._PROBE_GENERATOR[torch.device('cuda', 0)] = torch.Generator(
                device='cuda').manual_seed(seed)
            arg = cs._mesh_training(config, flat, batches, probe=True)
        rows, saved = [], cs.log
        cs.log = rows.append
        try:
            cs._check_mesh_steps(ranks[0]['training'], ref, arg, module, 'x')
            verdict = 'pass'
        except AssertionError as exc:
            verdict = 'FAIL ' + str(exc)[:200]
        finally:
            cs.log = saved
        held = [json.loads(r.split('JSON): ', 1)[1]) for r in rows
                if 'every held quantity' in r][0]
        pick = {r[1]: (round(r[2], 4), round(r[3], 4)) for r in held
                if r[1] in KEYS}
        worst = max(held, key=lambda r: r[2] / r[4])
        print(f'NOISE seed {seed}: {verdict}; (deviation, noise) {pick}; '
              f'worst {worst[1]} {worst[2] / worst[4]:.2f} of its bound',
              flush=True)
    cs.stop_processes()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('trees', nargs='*')
    parser.add_argument('--seeds', type=int, default=5)
    parser.add_argument('--in-tree', action='store_true')
    args = parser.parse_args()
    if args.in_tree:
        run_tree(args.seeds)
        return
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import ab
    print(ab.card(), flush=True)
    for tree in args.trees or ['.']:
        print(f'== {tree}', flush=True)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), '--in-tree',
             '--seeds', str(args.seeds)], cwd=tree, capture_output=True,
            text=True, timeout=1500)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith('NOISE')]
        print('\n'.join(lines) if lines and proc.returncode == 0 else
              f'FAILED rc {proc.returncode}\n{proc.stderr[-3000:]}',
              flush=True)


if __name__ == '__main__':
    main()
