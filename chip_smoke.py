"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``pb_sed_tpu_torch/csrc`` and
runs, in order:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA
   versions, kernel build time. Without a CUDA card it raises: there is
   no CPU path.
2. kernel vs plain: every forward kernel of the serving path against
   its plain PyTorch version on the card, at the shapes the full-width
   shallow FBCRNN gives it, with max|delta| against the stated tolerance
   and median CUDA-event times of both.
2b. backward kernel vs plain: the conv, pool and GRU backward kernels
   the same way, at the training step's shapes.
3. serving: the full-width shallow FBCRNN (random weights from a seed,
   passed through the weight bridge) serves batches of 32 ten-second
   clips through ``models.base.inference``'s tagging, boundaries
   detection and sound event detection; outputs are checked for shape,
   range and against the same model on the CPU, and every forward
   kernel's launch counter must have risen.
4. training: ``Trainer.train`` runs 8 steps of the full-width shallow
   FBCRNN with augmentation on, on batches of 32 ten-second clips
   (steps/s, clips/s, peak memory, the loss per step); all six launch
   counters must have risen in that run. A repeated batch with
   augmentation off must lower the loss over 5 steps; one B=4, T=100
   step agrees with the same model on the CPU (loss and every
   gradient); one step is profiled; the checkpoint restores with
   ``CRNN.from_storage_dir`` and serves a batch through tagging.

Any failure raises (non-zero exit). The line before the last is the
kernels' JSON record, the last line ``{"ok": true, "device": ...}``.
"""
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pb_sed_tpu.train.hooks import Hook
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.conv import (
    conv2d_same, conv2d_same_bwd, conv2d_same_bwd_plain, conv2d_same_plain,
    maxpool_freq2, maxpool_freq2_bwd, maxpool_freq2_bwd_plain,
    maxpool_freq2_plain)
from pb_sed_tpu_torch.ops.kernels.gru import (gru_scan, gru_scan_bwd,
                                              gru_scan_bwd_plain,
                                              gru_scan_plain)

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
    'conv2d_same_bwd': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/conv2d_bwd.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:642, '
                    'pb_sed_tpu/ops/pallas/conv.py:552, '
                    'pb_sed_tpu/ops/pallas/conv.py:599'},
    'maxpool_freq2_bwd': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/maxpool.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:1773'},
    'gru_scan_bwd': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/gru_bwd.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/gru.py:357'},
}
FORWARD = ('conv2d_same', 'maxpool_freq2', 'gru_scan')
# conv biases of the shallow FBCRNN that feed a training-mode batch norm
# (pre-activation towers, the output nets' first conv): their gradient is
# identically zero in exact arithmetic
BN_FED_BIASES = (
    {f'cnn.cnn_2d.conv_{i}.bias' for i in range(len(CONV_LAYERS))}
    | {f'cnn.cnn_1d.conv_{i}.bias' for i in range(4)}
    | {f'rnn_{d}.output_net.conv_0.bias' for d in ('fwd', 'bwd')})
BACKWARD = ('conv2d_same_bwd', 'maxpool_freq2_bwd', 'gru_scan_bwd')
TRAIN_STEPS = 8


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


def phase_kernels(records):
    """Kernel vs plain at the serving path's shapes. TF32 is off for the
    plain versions' f32 conv/matmul (cuDNN would default to TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log('TF32 off for cuDNN and cuBLAS (plain versions in full f32)')
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)

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


def phase_backward_kernels(records):
    """Backward kernel vs plain at the training step's shapes (B=32,
    T=500), TF32 off as in phase 2."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # dx: one f32 sum rounded once to bf16 on both sides (one bf16 ulp,
    # 2^-7 relative to max|ref|); dw: f32 sums over up to 2,048,000
    # pixels in another order, 1e-3 * max|ref|
    for f, cin, cout in CONV_LAYERS:
        x = randn(BATCH, FRAMES, f, cin).to(torch.bfloat16)
        w = randn(3, 3, cin, cout, scale=(9 * cin) ** -.5)
        gy = randn(BATCH, FRAMES, f, cout, scale=1e-3).to(torch.bfloat16)
        dx, dw = conv2d_same_bwd(x, w, gy)
        ref_dx, ref_dw = conv2d_same_bwd_plain(x, w, gy)
        torch.cuda.synchronize()
        shape = (BATCH, FRAMES, f, cin, cout)
        k_ms = cuda_ms(lambda: conv2d_same_bwd(x, w, gy), reps=5)
        p_ms = cuda_ms(lambda: conv2d_same_bwd_plain(x, w, gy), reps=5)
        _check('conv2d_same_bwd dx', shape, dx, ref_dx,
               2. ** -7 * float(ref_dx.float().abs().max()), k_ms, p_ms,
               records['conv2d_same_bwd'])
        _check('conv2d_same_bwd dw', shape, dw, ref_dw,
               1e-3 * float(ref_dw.abs().max()), 0., 0.,
               records['conv2d_same_bwd'])
        if not torch.equal(dw, conv2d_same_bwd(x, w, gy)[1]):
            raise AssertionError(f'conv2d_same_bwd {shape}: dw differs '
                                 f'between two runs')
        del x, gy, dx, dw, ref_dx, ref_dw
    # pool backward: a compare and a select, bit-exact, on tie-heavy
    # input (every padded frame ties)
    for f, c in POOLS:
        x = randn(BATCH, FRAMES, f, c).to(torch.bfloat16)
        x[:, FRAMES - 100:] = 0.
        gy = randn(BATCH, FRAMES, f // 2, c).to(torch.bfloat16)
        got = maxpool_freq2_bwd(x, gy)
        ref = maxpool_freq2_bwd_plain(x, gy)
        torch.cuda.synchronize()
        _check('maxpool_freq2_bwd', (BATCH, FRAMES, f, c), got, ref, 0.,
               cuda_ms(lambda: maxpool_freq2_bwd(x, gy)),
               cuda_ms(lambda: maxpool_freq2_bwd_plain(x, gy)),
               records['maxpool_freq2_bwd'])
    # GRU backward: same rounding points; summation order may flip a
    # bf16 rounding that the reverse sweep carries: 5.3e-3 * max|ref|
    d, b, t, h = GRU_SHAPES[0]
    xw = randn(d, b, t, 3 * h).to(torch.bfloat16)
    w_hh = randn(d, h, 3 * h, scale=h ** -.5)
    b_hh = randn(d, 3 * h, scale=.1)
    h0 = torch.zeros(d, b, h, device=dev)
    y = gru_scan(xw, w_hh, b_hh, h0)
    g = randn(d, b, t, h, scale=1e-2)
    got = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g)
    ref = gru_scan_bwd_plain(xw, w_hh, b_hh, h0, y, g)
    torch.cuda.synchronize()
    k_ms = cuda_ms(lambda: gru_scan_bwd(xw, w_hh, b_hh, h0, y, g), reps=5)
    p_ms = cuda_ms(lambda: gru_scan_bwd_plain(xw, w_hh, b_hh, h0, y, g),
                   reps=3, warmup=1)
    for name, a, r in zip(('dxw', 'dw_hh', 'db_hh', 'dh0'), got, ref):
        _check(f'gru_scan_bwd {name}', (d, b, t, h), a, r,
               5.3e-3 * float(r.float().abs().max()),
               k_ms if name == 'dxw' else 0., p_ms if name == 'dxw' else 0.,
               records['gru_scan_bwd'])
    torch.cuda.empty_cache()


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
    for name in FORWARD:
        if launches[name] <= 0:
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


def _train_batches(stft, n, batch_size, seconds, seed, k=10):
    """``n`` training batches of ``batch_size`` clips of ``seconds`` s at
    16 kHz: noise with zeroed tails (unequal lengths, the first clip
    full), weak targets with some soft (.5) entries, boundary targets
    for the weakly positive classes, and every third clip without frame
    labels (.5: not fully labeled)."""
    rng = np.random.RandomState(seed)
    samples = seconds * 16000
    frames = stft.num_frames(samples)
    out = []
    for _ in range(n):
        audio = (.1 * rng.randn(batch_size, samples)).astype(np.float32)
        valid = rng.randint(samples // 5, samples + 1, batch_size)
        valid[0] = samples
        audio[np.arange(samples)[None, :] >= valid[:, None]] = 0.
        seq_len = np.asarray(stft.num_frames(valid), np.int32)
        weak = (rng.rand(batch_size, k) > .7).astype(np.float32)
        weak[rng.rand(batch_size, k) > .9] = .5
        boundary = np.zeros((batch_size, k, frames), np.float32)
        for j in range(batch_size):
            for c in np.flatnonzero(weak[j] > .99):
                on, off = np.sort(rng.randint(0, seq_len[j], 2))
                boundary[j, c, on:off + 1] = 1.
        boundary[::3] = .5
        out.append({'audio_data': audio, 'seq_len': seq_len,
                    'weak_targets': weak, 'boundary_targets': boundary})
    return out


def _cosine(a, b):
    a = a.double().flatten()
    b = b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def _card_vs_cpu(make_model, stft):
    """One B=4, T=100 step, augmentation off, on the card and on the CPU
    (plain versions). The loss within 1e-4 + 3e-2 * |ref|. The CPU's own
    noise is the largest gap between its step and three CPU steps on the
    same clips in other batch orders (the same function; bf16 roundings
    through nine training-mode norms move the tower's gradients by ~25%
    there, cosine ~0.96). Each gradient tensor of 16 or more entries
    that is not a norm-fed bias lies within 1e-4 + 3.5e-2 * max|ref| or
    three times that noise. The entry norm's two scalars and the norm-fed biases (an
    identically zero gradient) are printed only: a single sum that
    cancels to near zero has no stable noise estimate. All gradients
    together agree with the CPU's at a cosine no more than 0.02 below
    the lowest cosine between the CPU's own batch orders."""
    batch = _train_batches(stft, 1, 4, 2, seed=3)[0]
    orders = ([0, 1, 2, 3], [3, 2, 1, 0], [1, 2, 3, 0], [2, 3, 0, 1])
    runs = [('cuda', orders[0])] + [('cpu', order) for order in orders]
    grads, losses = [], []
    for device, order in runs:
        model = make_model(augment=False).to(device)
        model.module.train()
        clips = {key: value[order].copy() for key, value in batch.items()}
        loss, _ = model.loss(model.to_device(clips))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.detach().float().cpu()
                      for n, p in model.module.named_parameters()})
    card, cpu, others = grads[0], grads[1], grads[2:]
    log(f'card vs CPU, B=4 T=100 step: loss {losses[0]:.6f} vs '
        f'{losses[1]:.6f} (CPU in other batch orders: '
        + ', '.join(f'{x:.6f}' for x in losses[2:]) + ')')
    if not abs(losses[0] - losses[1]) <= 1e-4 + 3e-2 * abs(losses[1]):
        raise AssertionError(f'card and CPU losses differ: {losses}')
    worst = 0.
    for name, ref in cpu.items():
        got = card[name]
        if not torch.isfinite(got).all():
            raise AssertionError(f'{name}: non-finite gradient on the card')
        gap = float((got - ref).abs().max())
        noise = max(float((o[name] - ref).abs().max()) for o in others)
        bound = max(1e-4 + 3.5e-2 * float(ref.abs().max()), 3 * noise)
        checked = ref.numel() >= 16 and name not in BN_FED_BIASES
        log(f'  grad {name}: |d| {gap:.3e} bound {bound:.3e} (CPU noise '
            f'{noise:.3e}) cos {_cosine(got, ref):.4f}'
            f'{"" if checked else " (printed only)"}')
        if checked:
            worst = max(worst, gap / bound)
            if gap > bound:
                raise AssertionError(f'{name}: card and CPU gradients '
                                     f'differ by {gap} > {bound}')
    def flat(g):
        return torch.cat([t.flatten() for t in g.values()])

    total = _cosine(flat(card), flat(cpu))
    floor = min(_cosine(flat(o), flat(cpu)) for o in others)
    log(f'card vs CPU gradients: worst |d|/bound {worst:.2f}, cosine of '
        f'all gradients {total:.5f} (CPU vs its other batch orders: '
        f'>= {floor:.5f})')
    if total < floor - .02:
        raise AssertionError(f'card and CPU gradients differ: cosine '
                             f'{total} < {floor} - 0.02')


class _StepLog(Hook):
    """A trainer hook: host clock and loss after each step (the clock
    read after a device synchronize)."""

    def __init__(self):
        self.times, self.losses = [], []

    def pre_step(self, trainer):
        if not self.times:
            torch.cuda.synchronize()
            self.times.append(time.perf_counter())

    def post_step(self, trainer, batch, loss, summary):
        self.losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        self.times.append(time.perf_counter())


def _profile_step(trainer, batch):
    """Device time of one training step by kernel (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = []
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue  # operator rows repeat their kernels' device time
        us = getattr(event, 'self_device_time_total', None)
        if us is None:
            us = getattr(event, 'self_cuda_time_total', 0.)
        if us > 0:
            rows.append((us / 1e3, event.key, event.count))
    rows.sort(reverse=True)
    total = sum(ms for ms, _, _ in rows)
    ours = ('conv2d_igemm', 'conv2d_dw_', 'gru_scan_kernel', 'gru_bwd',
            'maxpool_freq2')
    mine = sum(ms for ms, key, _ in rows if any(k in key for k in ours))
    log(f'profiled step: wall {wall:.1f} ms (profiler on), kernels busy '
        f'{total:.1f} ms (idle share {100 * (1 - total / wall):.0f}%), '
        f'hand-written kernels {mine:.1f} ms '
        f'({100 * mine / max(total, 1e-9):.0f}% of busy)')
    for ms, key, count in rows[:15]:
        log(f'  {ms:8.2f} ms  x{count:<5d} {key[:90]}')


def phase_training():
    """The full-width shallow FBCRNN trained on the card through
    ``Trainer``; returns the kernels' launch counts of that run."""
    from pb_sed_tpu.train.hooks import LRAnnealingHook
    from pb_sed_tpu.utils.config import config_to_json
    from pb_sed_tpu.utils.misc import dump_json
    from pb_sed_tpu_torch import bridge
    from pb_sed_tpu_torch.models import base
    from pb_sed_tpu_torch.models.net_configs import fbcrnn_config
    from pb_sed_tpu_torch.models.weak_label import CRNN
    from pb_sed_tpu_torch.train.optimizer import Adam
    from pb_sed_tpu_torch.train.trainer import Trainer

    def config(augment):
        return CRNN.get_config(fbcrnn_config('shallow', augment=augment))

    flat = bridge.random_flat(CRNN.from_config(config(True)).state_dict(),
                              seed=0)

    def make_model(augment):
        model = CRNN.from_config(config(augment))
        model.load_state_dict(flat)
        return model

    model = make_model(augment=True).to('cuda')
    stft = model.module.feature_extractor.stft
    batches = _train_batches(stft, 4, BATCH, 10, seed=1)
    step_log = _StepLog()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, optimizer=Adam(lr=5e-4), storage_dir=tmp,
                          summary_trigger=(4, 'iteration'),
                          stop_trigger=(TRAIN_STEPS, 'iteration'))
        trainer.register_hook(LRAnnealingHook(
            breakpoints=[(0, .1), (TRAIN_STEPS, 1.)]))
        trainer.register_hook(step_log)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        trainer.train(batches * (TRAIN_STEPS // len(batches)))
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        log(f'launches in the training run: {launches}')
        for name in KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f'kernel {name} never launched in '
                                     f'the training run')
        log('loss per step: ' + ', '.join(f'{x:.5f}'
                                          for x in step_log.losses))
        if len(step_log.losses) != TRAIN_STEPS or not np.isfinite(
                step_log.losses).all():
            raise AssertionError(f'training losses: {step_log.losses}')
        steps = np.diff(step_log.times)
        steady = steps[2:]  # steps 1-2: cuBLAS/cuFFT plans, allocator
        log(f'step times (host clock, synchronized): '
            + ', '.join(f'{1e3 * x:.1f}' for x in steps) + ' ms')
        log(f'training: {1 / steady.mean():.3f} steps/s = '
            f'{BATCH / steady.mean():.1f} clips/s over steps 3-'
            f'{TRAIN_STEPS} (batch {BATCH} x 10 s clips, augmentation '
            f'on, host clock)')
        log(f'peak device memory (training): '
            f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
        with open(f'{tmp}/summary.jsonl') as fid:
            summary = [json.loads(line) for line in fid]
        log(f'summary.jsonl: {len(summary)} lines, last {summary[-1]}')

        # the checkpoint restores and serves
        dump_json({'trainer': {'model': config_to_json(config(True))}},
                  f'{tmp}/1/config.json')
        restored = CRNN.from_storage_dir(tmp, checkpoint_name='ckpt_latest.pkl',
                                         device='cuda')
        serve = {'audio_data': batches[0]['audio_data'][:8],
                 'seq_len': batches[0]['seq_len'][:8],
                 'example_id': [f'clip{j}' for j in range(8)]}
        tags = base.tagging(restored, [serve])
        ref = base.tagging(model, [serve])
        err = max(float(np.abs(tags[c] - ref[c]).max()) for c in ref)
        log(f'restored checkpoint serves: tagging of 8 clips, max|d| vs '
            f'the trained model {err:.3e}')
        if not err <= 1e-5 or not all(np.isfinite(v).all()
                                      for v in tags.values()):
            raise AssertionError('the restored checkpoint serves other '
                                 'scores than the trained model')
        _profile_step(trainer, batches[0])
    del trainer, model, restored
    torch.cuda.empty_cache()

    # the loss falls on a repeated batch (augmentation off)
    model = make_model(augment=False).to('cuda')
    trainer = Trainer(model, optimizer=Adam(lr=1e-3))
    losses = [float(trainer.train_step(batches[1])) for _ in range(5)]
    log('repeated batch, augmentation off: loss ' + ', '.join(
        f'{x:.5f}' for x in losses))
    if not losses[-1] < losses[0]:
        raise AssertionError(f'the loss did not fall: {losses}')
    del trainer, model
    torch.cuda.empty_cache()
    _card_vs_cpu(make_model, stft)
    return launches


def main():
    card = phase_card()
    records = {name: {'max_abs_err': 0., 'ms': 0., 'plain_ms': 0.}
               for name in KERNELS}
    phase_kernels(records)
    phase_backward_kernels(records)
    serving = phase_slice()
    training = phase_training()
    kernels = [
        {'name': name, **KERNELS[name], 'launches': training[name],
         **({'launches_serving': serving[name]} if name in FORWARD else {}),
         **records[name]}
        for name in KERNELS]
    print(card)                           # nvidia-smi name, power.limit
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
