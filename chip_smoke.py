"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``pb_sed_tpu_torch/csrc`` and
runs, in order:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA
   versions, kernel build time. Without a CUDA card it raises: there is
   no CPU path.
2. kernel vs plain: every kernel of the serving path against its plain
   PyTorch version on the card, at the shapes the full-width shallow
   FBCRNN gives it, with max|delta| against the stated tolerance and
   median CUDA-event times of both.
3. the slice: the full-width shallow FBCRNN (random weights from a seed,
   passed through the weight bridge) serves batches of 32 ten-second
   clips through ``models.base.inference``'s tagging, boundaries
   detection and sound event detection; outputs are checked for shape,
   range and against the same model on the CPU, and every kernel's
   launch counter must have risen.

Any failure raises (non-zero exit). The line before the last is the
kernels' JSON record, the last line ``{"ok": true, "device": ...}``.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.conv import (conv2d_same,
                                               conv2d_same_plain,
                                               maxpool_freq2,
                                               maxpool_freq2_plain)
from pb_sed_tpu_torch.ops.kernels.gru import gru_scan, gru_scan_plain

BATCH, FRAMES = 32, 500           # 32 ten-second 16 kHz clips, shift 320
# (F, Cin, Cout) of the shallow CNN2d (net_configs.cnn_config('shallow'))
CONV_LAYERS = [(128, 1, 16), (128, 16, 16), (64, 16, 32), (64, 32, 32),
               (32, 32, 64), (32, 64, 64), (16, 64, 128), (16, 128, 128),
               (8, 128, 256)]
# (F, C) entering each (2, 1) freq pool (after layers 1, 3, 5, 7)
POOLS = [(128, 16), (64, 32), (32, 64), (16, 128)]
# (D, B, T, H): tagging/boundaries (B clips x T frames) and sliding-window
# SED at window 51, shift 1 (B * T windows x 51 frames)
GRU_SHAPES = [(2, BATCH, FRAMES, 256), (2, BATCH * FRAMES, 51, 256)]

KERNELS = {
    'conv2d_same': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/conv2d.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:413'},
    'maxpool_freq2': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/maxpool.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:1759'},
    'gru_scan': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/gru.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/gru.py:50'},
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def phase_card():
    if not torch.cuda.is_available():
        raise RuntimeError('chip_smoke.py needs a CUDA card; '
                           'torch.cuda.is_available() is False')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f'card: {card}')
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'python {sys.version.split()[0]}, device count '
        f'{torch.cuda.device_count()}')
    t0 = time.perf_counter()
    path = build.build()
    build.lib()
    log(f'kernel build+load: {time.perf_counter() - t0:.1f} s -> {path}')
    ptxas = [line for line in path.with_suffix('.log').read_text()
             .splitlines() if 'registers' in line or 'spill' in line]
    for line in ptxas:
        log(f'  ptxas: {line.strip()}')
    return card


def _check(name, shape, got, ref, tol, k_ms, p_ms, record):
    err = float((got.float() - ref.float()).abs().max())
    ok = err <= tol
    log(f'{name} {shape}: max|d|={err:.3e} tol={tol:.3e} '
        f'kernel={k_ms:.3f} ms plain={p_ms:.3f} ms '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'{name} {shape}: kernel differs from plain '
                             f'version by {err} > {tol}')
    record['max_abs_err'] = max(record['max_abs_err'], err)
    record['ms'] += k_ms
    record['plain_ms'] += p_ms


def phase_kernels():
    """Kernel vs plain at the serving path's shapes. TF32 is off for the
    plain versions' f32 conv/matmul (cuDNN would default to TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log('TF32 off for cuDNN and cuBLAS (plain versions in full f32)')
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    records = {name: {'max_abs_err': 0., 'ms': 0., 'plain_ms': 0.}
               for name in KERNELS}

    def randn(*shape, scale=1.):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # conv: both sides round the same f32 sum once to bf16; a different
    # summation order may flip that rounding by one bf16 ulp (2^-8
    # relative), so the bound is 2^-7 * max|ref|
    for f, cin, cout in CONV_LAYERS:
        x = randn(BATCH, FRAMES, f, cin).to(torch.bfloat16)
        w = randn(3, 3, cin, cout, scale=(9 * cin) ** -.5)
        b = randn(cout, scale=.1)
        got = conv2d_same(x, w, b)
        ref = conv2d_same_plain(x, w, b)
        torch.cuda.synchronize()
        tol = 2. ** -7 * float(ref.float().abs().max())
        _check('conv2d_same', (BATCH, FRAMES, f, cin, cout), got, ref, tol,
               cuda_ms(lambda: conv2d_same(x, w, b)),
               cuda_ms(lambda: conv2d_same_plain(x, w, b)),
               records['conv2d_same'])
    # max-pool: a compare and a copy, bit-exact
    for f, c in POOLS:
        x = randn(BATCH, FRAMES, f, c).to(torch.bfloat16)
        got = maxpool_freq2(x)
        ref = maxpool_freq2_plain(x)
        torch.cuda.synchronize()
        _check('maxpool_freq2', (BATCH, FRAMES, f, c), got, ref, 0.,
               cuda_ms(lambda: maxpool_freq2(x)),
               cuda_ms(lambda: maxpool_freq2_plain(x)),
               records['maxpool_freq2'])
    # GRU: same bf16 rounding points on both sides; the recurrence
    # carries accumulation-order differences through T steps. Bound:
    # the kernel-vs-scan drift measured for the TPU kernel, 5.3e-3.
    for d, b, t, h in GRU_SHAPES:
        xw = randn(d, b, t, 3 * h).to(torch.bfloat16)
        w_hh = randn(d, h, 3 * h, scale=h ** -.5)
        b_hh = randn(d, 3 * h, scale=.1)
        h0 = torch.zeros(d, b, h, device=dev)
        got = gru_scan(xw, w_hh, b_hh, h0)
        ref = gru_scan_plain(xw, w_hh, b_hh, h0)
        torch.cuda.synchronize()
        _check('gru_scan', (d, b, t, h), got, ref, 5.3e-3,
               cuda_ms(lambda: gru_scan(xw, w_hh, b_hh, h0), reps=5),
               cuda_ms(lambda: gru_scan_plain(xw, w_hh, b_hh, h0), reps=3,
                       warmup=1),
               records['gru_scan'])
        del xw, got, ref
    torch.cuda.empty_cache()
    return records


def _synthetic_batches(stft, seed=0):
    """Three batches of 32 ten-second 16 kHz clips (tones in noise); the
    second batch has unequal lengths (zeroed tails, shorter seq_len)."""
    rng = np.random.RandomState(seed)
    samples = 10 * 16000
    t = np.arange(samples) / 16000.
    batches = []
    for i in range(3):
        audio = .05 * rng.randn(BATCH, samples)
        for j in range(BATCH):
            on, off = np.sort(rng.uniform(0., 10., 2))
            freq = rng.uniform(200., 4000.)
            audio[j] += (.5 * np.sin(2 * np.pi * freq * t)
                         * ((t >= on) & (t < off)))
        valid = np.full(BATCH, samples)
        if i == 1:
            valid = rng.randint(2 * 16000, samples + 1, BATCH)
            valid[0] = samples
            audio[np.arange(samples)[None, :] >= valid[:, None]] = 0.
        batches.append({
            'audio_data': audio.astype(np.float32),
            'seq_len': np.asarray(stft.num_frames(valid), np.int32),
            'example_id': [f'b{i}_clip{j:02d}' for j in range(BATCH)],
        })
    return batches


# (name, inference function, kwargs) of the served methods
def _methods(base):
    return [
        ('tagging', base.tagging, {}),
        ('boundaries_detection', base.boundaries_detection, {}),
        ('sed_w51_s1', base.sound_event_detection,
         {'model_kwargs': {'window_length': 51, 'window_shift': 1}}),
        ('sed_w250_s250', base.sound_event_detection,
         {'model_kwargs': {'window_length': 250, 'window_shift': 250}}),
    ]


def _expected_frames(name, seq_len):
    if name == 'tagging':
        return 1
    if name == 'sed_w250_s250':
        return 1 + (seq_len - 1) // 250
    return seq_len


def phase_slice():
    """The full-width shallow FBCRNN served on the card through the
    inference engine; returns the kernels' launch counts of that run."""
    from pb_sed_tpu_torch import bridge
    from pb_sed_tpu_torch.models import base
    from pb_sed_tpu_torch.models.net_configs import fbcrnn_config
    from pb_sed_tpu_torch.models.weak_label import CRNN

    def make_model(flat=None):
        model = CRNN.from_config(CRNN.get_config(fbcrnn_config('shallow')))
        if flat is not None:
            model.load_state_dict(flat)   # bridge.load_flat
        return model

    template = make_model()
    flat = bridge.random_flat(template.state_dict(), seed=0)
    template.load_state_dict(flat)
    flat = template.state_dict()          # bridge.export_flat
    model = make_model(flat).to('cuda')
    log(f'FBCRNN shallow: {model.num_parameters()} parameters, '
        f'{len(flat)} flat tensors')
    stft = model.module.feature_extractor.stft
    batches = _synthetic_batches(stft)
    k = 10
    methods = _methods(base)
    for name, fn, kwargs in methods:      # warm-up: cuFFT/cuBLAS plans
        fn(model, batches[:1], **kwargs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    build.reset_launches()
    results = {}
    for name, fn, kwargs in methods:
        t0 = time.perf_counter()
        results[name] = fn(model, batches, **kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f'{name}: {3 * BATCH} clips in {dt:.3f} s = '
            f'{3 * BATCH / dt:.1f} clips/s (host clock, inference engine '
            f'included)')
    launches = dict(build.LAUNCHES)
    log(f'launches in the served run: {launches}')
    log(f'peak device memory: '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f'kernel {name} never launched on the '
                                 f'served path')

    for name, scores in results.items():
        for batch in batches:
            for clip, sl in zip(batch['example_id'], batch['seq_len']):
                y = scores[clip]
                want = (_expected_frames(name, int(sl)), k)
                if y.shape != want:
                    raise AssertionError(f'{name} {clip}: shape {y.shape} '
                                         f'!= {want}')
                if not np.isfinite(y).all():
                    raise AssertionError(f'{name} {clip}: non-finite')
                if y.min() < 1e-5 or y.max() > 1 - 1e-5:
                    raise AssertionError(
                        f'{name} {clip}: scores outside [1e-5, 1 - 1e-5]: '
                        f'[{y.min()}, {y.max()}]')
    log('shapes, finiteness and score range: ok')

    # the same model on the CPU (plain versions) for the first two clips
    # of the unequal-length batch; tolerance atol = 1e-4 + 3e-2 * max|ref|
    # (bf16 paths that round at different points)
    cpu_model = make_model(flat)
    first = {key: val[:2] for key, val in batches[1].items()}
    for name, fn, kwargs in methods:
        ref = fn(cpu_model, [first], **kwargs)
        for clip in first['example_id']:
            a, b = results[name][clip], ref[clip]
            err = float(np.abs(a - b).max())
            tol = 1e-4 + 3e-2 * float(np.abs(b).max())
            log(f'card vs CPU {name} {clip}: max|d|={err:.3e} '
                f'tol={tol:.3e}')
            if not err <= tol:
                raise AssertionError(f'{name} {clip}: card and CPU differ '
                                     f'by {err} > {tol}')
    return launches


def main():
    card = phase_card()
    records = phase_kernels()
    launches = phase_slice()
    kernels = [
        {'name': name, **KERNELS[name], 'launches': launches[name],
         **records[name]}
        for name in KERNELS]
    print(card)                           # nvidia-smi name, power.limit
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
