"""Training steps/s and a profiled step's device time of phase 14b's
tower (the deep recipe at 40 mel bins, 24 channels in its first four 2-D
layers, unfused) in two checkouts of this repository, A B B A on one CUDA
card.

    python3 scripts/perf/tower_step_ab.py TREE_A TREE_B [--rounds 1]

A process in each tree (its own ``pb_sed_tpu_torch`` and kernel build)
builds the model with that tree's ``chip_smoke.py`` helpers (random
weights from seed 0), trains 8 steps on batches of 32 ten-second clips
with augmentation on (host clock over steps 3-8, a synchronize each
step) and profiles one more step (``torch.profiler``): its device ms in
all kernels and in the conv kernels (names holding ``conv2d``). The
card's name and power limit come first; each tree's rounds are printed.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import ab  # noqa: E402

STEPS = 8


def time_tree():
    """Run inside a tree: print one line ``STEP {json}``."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from pb_sed_tpu_torch.train.optimizer import Adam
    from pb_sed_tpu_torch.train.trainer import Trainer
    flat = cs._random_flat(cs._tower_config('14b'))
    model = cs._model(cs._tower_config('14b', False, True), flat).to('cuda')
    stft = model.module.feature_extractor.stft
    batches = cs._train_batches(stft, 4, cs.BATCH, 10, seed=1, k=527)
    trainer = Trainer(model, optimizer=Adam(**cs._DEEP_RECIPE['adam']))
    times = []
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    cs.collect_garbage()
    rows = cs.profile_kernels(lambda: trainer.train_step(batches[0]))
    out = {'steps_per_s': 1. / float(np.mean(times[2:])),
           'busy_ms': sum(ms for ms, _, _ in rows),
           'conv_ms': sum(ms for ms, key, _ in rows if 'conv2d' in key)}
    print('STEP ' + json.dumps(out), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('trees', nargs=2)
    parser.add_argument('--rounds', type=int, default=1)
    parser.add_argument('--time', action='store_true')
    args, _ = parser.parse_known_args()
    print(ab.card(), flush=True)
    script = Path(__file__).resolve()
    runs = ab.alternate(args.trees[0], args.trees[1], args.rounds,
                        lambda tree: ab.run_child(script, tree,
                                                  ('STEP',))['STEP'])
    for side, tree in zip('AB', args.trees):
        for res in runs[side]:
            print(f'{side} ({tree}) 14b: {res["steps_per_s"]:.3f} steps/s, '
                  f'profiled step {res["busy_ms"]:.2f} ms device, conv '
                  f'kernels {res["conv_ms"]:.2f} ms', flush=True)


if __name__ == '__main__':
    if '--time' in sys.argv:
        time_tree()
    else:
        main()
