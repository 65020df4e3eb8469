"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``pb_sed_tpu_torch/csrc`` and
runs, in order:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA
   versions, kernel build time. Without a CUDA card it raises: there is
   no CPU path.
2, 2b. kernel vs plain: every kernel, forward (2) and backward (2b),
   against its plain PyTorch version on the card at the shapes the
   full-width shallow FBCRNN gives it (B=32 ten-second clips), with
   max|delta| against the stated tolerance, median CUDA-event times of
   both and of one PyTorch library call that computes the same function
   where there is one (cuDNN's bf16 channels-last conv and its backward,
   the max and average pools), and the least time the card could take
   (bytes at 3.35 TB/s or operations at 989 TFLOP/s bf16 / 67 TFLOP/s
   f32, whichever is larger). The BN+ReLU-fused conv and its backward
   run at the shallow tower's fused layers L1-L8, with a scale and shift
   that make about half the pre-activations negative and the shift often
   positive (a lit SAME halo or a wrong gate shows).
2c. the same at the deep recipe's shapes: the conv at the nine deep 3x3
   layers (L14 and L16 are the shapes where the JAX package takes its
   channel-blocked kernel), the fused conv at L2-L16, the max-pool at the
   deep tower's four pools, the residual average pool at the four pool
   crossings (bit-exact), the GRU at H = 512; the fused GRU backward
   (split=False, no path selects it, as in the JAX package) at H = 256
   and 512 against its plain version and the split kernel; then the 1x1
   convs, which run as a bf16 matmul.
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
5. the deep recipe (``fbcrnn_config('deep')``, full width, random
   weights): tagging of 3 batches of 32 ten-second clips by the 527-class
   AudioSet model and SED at window 51 / shift 1 of one batch by a
   10-class model, checked like phase 3; ``Trainer.train`` for 8 steps at
   32 clips with the AudioSet recipe's settings (lr 1e-4 with a ramp,
   gradient clipping 0.1, no strong loss, augmentation on), then the
   checks of phase 4. Every launch counter must rise in the training run,
   the avg-pool pair's too.
6. the deep recipe with ``cnn_2d.fuse_bn = True`` from phase 5's weights:
   527-class tagging of the same 3 x 32 clips, which must agree with phase
   5's unfused model and with the CPU, and 8 ``Trainer`` steps with
   phase 4's checks, steps/s, clips/s and peak memory beside phase 5's.
   Per forward, ``bnrelu_conv2d_same`` launches 8 times (L2-L16) and
   ``conv2d_same`` once (L0); the fused backward rises in training. Then
   the shallow recipe with ``fuse_bn``: one batch served, 2 training
   steps, the card-vs-CPU step.

Each path (shallow serving and training, deep serving and training, the
fused ones) runs with the launch counters set to 0 just before it and
read just after.
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
import torch.nn.functional as F

from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.conv import (
    avgpool_freq2, avgpool_freq2_bwd, avgpool_freq2_bwd_plain,
    avgpool_freq2_plain, bnrelu_conv2d_same, bnrelu_conv2d_same_bwd,
    bnrelu_conv2d_same_bwd_plain, bnrelu_conv2d_same_plain, conv2d_same,
    conv2d_same_bwd, conv2d_same_bwd_plain, conv2d_same_plain, maxpool_freq2,
    maxpool_freq2_bwd, maxpool_freq2_bwd_plain, maxpool_freq2_plain)
from pb_sed_tpu_torch.ops.kernels.gru import (gru_scan, gru_scan_bwd,
                                              gru_scan_bwd_plain,
                                              gru_scan_plain)
from pb_sed_tpu_torch.train.hooks import Hook

BATCH, FRAMES = 32, 500           # 32 ten-second 16 kHz clips, shift 320
# (name, F, Cin, Cout) of the shallow CNN2d's layers
# (net_configs.cnn_config('shallow'))
CONV_LAYERS = [
    ('L0', 128, 1, 16), ('L1', 128, 16, 16), ('L2', 64, 16, 32),
    ('L3', 64, 32, 32), ('L4', 32, 32, 64), ('L5', 32, 64, 64),
    ('L6', 16, 64, 128), ('L7', 16, 128, 128), ('L8', 8, 128, 256)]
# (F, C) entering each (2, 1) freq pool (after layers 1, 3, 5, 7)
POOLS = [(128, 16), (64, 32), (32, 64), (16, 128)]
# (D, B, T, H): tagging/boundaries and training (B clips x T frames) and
# sliding-window SED at window 51, shift 1 (B * T windows x 51 frames)
GRU_SHAPES = [(2, BATCH, FRAMES, 256), (2, BATCH * FRAMES, 51, 256)]
# (name, F, Cin, Cout) of the deep CNN2d's 3x3 layers
# (net_configs.cnn_config('deep')); the 1x1 layers sit between them
DEEP_CONV_LAYERS = [
    ('L0', 128, 1, 32), ('L2', 128, 32, 32), ('L4', 64, 32, 64),
    ('L6', 64, 64, 64), ('L8', 32, 64, 128), ('L10', 32, 128, 128),
    ('L12', 16, 128, 256), ('L14', 16, 256, 256), ('L16', 8, 256, 512)]
# the deep layers where the JAX package takes _fwd_kernel_cb (_cb_of(Cin))
CHANNEL_BLOCKED = ('L14', 'L16')
# (F, C) entering each of the deep tower's (2, 1) max-pools (after
# layers 3, 7, 11, 15)
DEEP_POOLS = [(128, 32), (64, 64), (32, 128), (16, 256)]
# (F, C) of the residuals that cross a (2, 1) pool: 2 -> 4, 6 -> 8,
# 10 -> 12, 14 -> 16, each matched to F / 2 rows and 2C channels
DEEP_CROSSINGS = [(128, 32), (64, 64), (32, 128), (16, 256)]
DEEP_GRU_SHAPES = [(2, BATCH, FRAMES, 512), (2, BATCH * FRAMES, 51, 512)]

# name: route, source, the TPU kernel(s) it replaces, and the path whose
# launch count the kernels line reports as ``launches``
KERNELS = {
    'conv2d_same': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/conv2d.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:413, '
                    'pb_sed_tpu/ops/pallas/conv.py:508'},
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
    'avgpool_freq2': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/avgpool.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:1862'},
    'avgpool_freq2_bwd': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/avgpool.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:1875'},
    'bnrelu_conv2d_same': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/conv2d.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:1306, '
                    'pb_sed_tpu/ops/pallas/conv.py:1362'},
    'bnrelu_conv2d_same_bwd': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/conv2d_bwd.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:1403, '
                    'pb_sed_tpu/ops/pallas/conv.py:552, '
                    'pb_sed_tpu/ops/pallas/conv.py:1469'},
    'gru_scan_bwd_fused': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/gru_bwd_fused.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/gru.py:237'},
}
# the path each kernel's ``launches`` is read from: the deep training run
# drives the unfused kernels, the deep fuse_bn training run the fused
# conv pair; no path selects the fused GRU backward (as in the JAX
# package), so its count is that of its kernel phase
MAIN_PATH = dict({name: 'deep_training' for name in KERNELS},
                 bnrelu_conv2d_same='deep_fuse_bn_training',
                 bnrelu_conv2d_same_bwd='deep_fuse_bn_training',
                 gru_scan_bwd_fused='kernel_phase')
FORWARD = ('conv2d_same', 'maxpool_freq2', 'gru_scan')
SHALLOW = ('conv2d_same', 'maxpool_freq2', 'gru_scan', 'conv2d_same_bwd',
           'maxpool_freq2_bwd', 'gru_scan_bwd')
DEEP = SHALLOW + ('avgpool_freq2', 'avgpool_freq2_bwd')
FUSED = ('bnrelu_conv2d_same', 'bnrelu_conv2d_same_bwd')
TRAIN_STEPS = 8
# the card's peak rates (NVIDIA H100 SXM data sheet, dense): HBM bytes/s,
# bf16 tensor-core and f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


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


def bound(nbytes, tensor_flops=0., vector_ops=0.):
    """The least time (ms) the card could take for work that moves
    ``nbytes`` (each input read once, each output written once) and does
    ``tensor_flops`` bf16 tensor-core and ``vector_ops`` f32 operations,
    and which of the two binds: (ms, 'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = tensor_flops / BF16_FLOPS + vector_ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def new_record():
    """A kernel's sums. A time no check measured stays None (printed as
    null), never 0."""
    return {'max_abs_err': 0., 'bound_ms': 0., 'bound_bytes_ms': 0.,
            'bound_operations_ms': 0., 'library_ms': None,
            **{f'{label}_{kind}': None for label in ('shallow', 'deep')
               for kind in ('ms', 'plain_ms', 'library_ms')}}


def _add(record, key, value):
    record[key] = (record[key] or 0.) + value


def _total(*values):
    """Sum of the measured values; None when none was measured."""
    measured = [v for v in values if v is not None]
    return sum(measured) if measured else None


def _check(name, shape, got, ref, tol, k_ms, p_ms, record, label,
           lib_ms=None, work=None):
    """Hold a kernel's result against its plain version; add its times
    (kernel, plain, library call) and its bound (``work``: (ms, side))
    to ``record``."""
    err = float((got.float() - ref.float()).abs().max())
    ok = err <= tol
    extra = '' if lib_ms is None else f' library={lib_ms:.3f} ms'
    if work is not None:
        extra += f' bound={work[0]:.3f} ms ({work[1]})'
    log(f'{name} {shape}: max|d|={err:.3e} tol={tol:.3e} '
        f'kernel={k_ms:.3f} ms plain={p_ms:.3f} ms{extra} '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'{name} {shape}: kernel differs from plain '
                             f'version by {err} > {tol}')
    record['max_abs_err'] = max(record['max_abs_err'], err)
    _add(record, f'{label}_ms', k_ms)
    _add(record, f'{label}_plain_ms', p_ms)
    if lib_ms is not None:
        _add(record, f'{label}_library_ms', lib_ms)
        _add(record, 'library_ms', lib_ms)
    if work is not None:
        record['bound_ms'] += work[0]
        record[f'bound_{work[1]}_ms'] += work[0]


def _nchw(x):
    """(B, T, F, C) -> its NCHW view, channels-last in memory."""
    return x.permute(0, 3, 1, 2)


def _oihw(w):
    """(kt, kf, Cin, Cout) weights -> bf16 OIHW, channels-last."""
    return w.to(torch.bfloat16).permute(3, 0, 1, 2).contiguous().permute(
        0, 3, 1, 2)


def conv_work(p, cin, cout, taps=9, affine=False, backward=False):
    """Bytes and operations of the SAME conv (forward, or its dx + dw
    backward) over ``p`` pixels: bf16 activations and weights, f32 bias,
    dw and scale/shift; the fused conv's affine + ReLU is 3 f32
    operations per input element, once more for the backward's recompute
    of the post-activation buffer."""
    if backward:
        nbytes = 2 * p * cin + 2 * taps * cin * cout + 2 * p * cout \
            + 2 * p * cin + 4 * taps * cin * cout
        flops = 4. * p * taps * cin * cout
    else:
        nbytes = 2 * p * cin + 2 * taps * cin * cout + 4 * cout \
            + 2 * p * cout
        flops = 2. * p * taps * cin * cout
    if affine:
        nbytes += 8 * cin
    return bound(nbytes, flops, 3. * p * cin if affine else 0.)


def gru_work(d, b, t, h, backward=False):
    """Bytes and operations of the GRU recurrence (forward: xw bf16, w_hh
    bf16, b_hh and h0 f32 in, y f32 out; backward: also y and g f32 in,
    dxw bf16, dw_hh, db_hh and dh0 f32 out): the recurrent matmul (twice
    more backward: dh and dw_hh) and about 12 f32 gate operations per
    hidden unit and step (24 backward)."""
    rows = d * b * t
    nbytes = 2 * rows * 3 * h + 2 * d * h * 3 * h + 4 * d * 3 * h \
        + 4 * d * b * h + 4 * rows * h
    if backward:
        nbytes += 4 * rows * h + 2 * rows * 3 * h + 4 * d * h * 3 * h \
            + 4 * d * 3 * h + 4 * d * b * h
    return bound(nbytes, (3 if backward else 1) * 2. * rows * h * 3 * h,
                 (24 if backward else 12) * rows * h)


def check_kernels(records, label, seed, convs, pools, grus, crossings=(),
                  fused=()):
    """Every kernel vs its plain version at one model's shapes (B=32,
    T=500), forward and backward, with the launch-counted wrappers; the
    kernel, plain and library times (median CUDA-event ms) and the bounds
    add up into ``records[name]``. ``fused`` names the conv layers of
    ``convs`` that the BN+ReLU-fused conv runs at. TF32 is off for the
    plain versions' f32 conv/matmul (cuDNN would default to TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # conv: both sides round the same f32 sum once to bf16; a different
    # summation order may flip that rounding by one bf16 ulp, so y and dx
    # are held to 2^-7 * max|ref|; dw: f32 sums over up to 2,048,000
    # pixels in another order, 1e-3 * max|ref|, and the same in two runs.
    # The library call: cuDNN's bf16 conv on the channels-last tensors
    # (forward, and convolution_backward for dx and dw together).
    for layer, f, cin, cout in convs:
        x = randn(BATCH, FRAMES, f, cin).to(torch.bfloat16)
        w = randn(3, 3, cin, cout, scale=(9 * cin) ** -.5)
        b = randn(cout, scale=.1)
        gy = randn(BATCH, FRAMES, f, cout, scale=1e-3).to(torch.bfloat16)
        p = BATCH * FRAMES * f
        shape = (layer, BATCH, FRAMES, f, cin, cout)
        if layer in CHANNEL_BLOCKED:
            shape += ('_fwd_kernel_cb',)
        xn, wn, bn = _nchw(x), _oihw(w), b.to(torch.bfloat16)
        got = conv2d_same(x, w, b)
        ref = conv2d_same_plain(x, w, b)
        torch.cuda.synchronize()
        _check('conv2d_same', shape, got, ref,
               2. ** -7 * float(ref.float().abs().max()),
               cuda_ms(lambda: conv2d_same(x, w, b), reps=5),
               cuda_ms(lambda: conv2d_same_plain(x, w, b), reps=5),
               records['conv2d_same'], label,
               cuda_ms(lambda: F.conv2d(xn, wn, bn, padding=1), reps=5),
               conv_work(p, cin, cout))
        del got, ref
        dx, dw = conv2d_same_bwd(x, w, gy)
        ref_dx, ref_dw = conv2d_same_bwd_plain(x, w, gy)
        torch.cuda.synchronize()
        k_ms = cuda_ms(lambda: conv2d_same_bwd(x, w, gy), reps=5)
        p_ms = cuda_ms(lambda: conv2d_same_bwd_plain(x, w, gy), reps=5)
        gyn = _nchw(gy)
        lib_ms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
            gyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, True, False]), reps=5)
        _check('conv2d_same_bwd dx', shape, dx, ref_dx,
               2. ** -7 * float(ref_dx.float().abs().max()), k_ms, p_ms,
               records['conv2d_same_bwd'], label, lib_ms,
               conv_work(p, cin, cout, backward=True))
        _check('conv2d_same_bwd dw', shape, dw, ref_dw,
               1e-3 * float(ref_dw.abs().max()), 0., 0.,
               records['conv2d_same_bwd'], label)
        if not torch.equal(dw, conv2d_same_bwd(x, w, gy)[1]):
            raise AssertionError(f'conv2d_same_bwd {shape}: dw differs '
                                 f'between two runs')
        del dx, dw, ref_dx, ref_dw
        if layer in fused:
            # scale in [.5, 1.5), shift ~ N(0, .5^2): about half the
            # pre-activations negative, the shift often positive
            scale = .5 + torch.rand(cin, generator=gen, device=dev)
            shift = randn(cin, scale=.5)
            args = (x, scale, shift, w)
            got = bnrelu_conv2d_same(*args, b)
            ref = bnrelu_conv2d_same_plain(*args, b)
            torch.cuda.synchronize()
            _check('bnrelu_conv2d_same', shape, got, ref,
                   2. ** -7 * float(ref.float().abs().max()),
                   cuda_ms(lambda: bnrelu_conv2d_same(*args, b), reps=5),
                   cuda_ms(lambda: bnrelu_conv2d_same_plain(*args, b),
                           reps=5),
                   records['bnrelu_conv2d_same'], label, None,
                   conv_work(p, cin, cout, affine=True))
            del got, ref
            da, dw = bnrelu_conv2d_same_bwd(*args, gy)
            ref_da, ref_dw = bnrelu_conv2d_same_bwd_plain(*args, gy)
            torch.cuda.synchronize()
            k_ms = cuda_ms(lambda: bnrelu_conv2d_same_bwd(*args, gy), reps=5)
            p_ms = cuda_ms(lambda: bnrelu_conv2d_same_bwd_plain(*args, gy),
                           reps=5)
            _check('bnrelu_conv2d_same_bwd da', shape, da, ref_da,
                   2. ** -7 * float(ref_da.float().abs().max()), k_ms, p_ms,
                   records['bnrelu_conv2d_same_bwd'], label, None,
                   conv_work(p, cin, cout, affine=True, backward=True))
            _check('bnrelu_conv2d_same_bwd dw', shape, dw, ref_dw,
                   1e-3 * float(ref_dw.abs().max()), 0., 0.,
                   records['bnrelu_conv2d_same_bwd'], label)
            if not torch.equal(dw, bnrelu_conv2d_same_bwd(*args, gy)[1]):
                raise AssertionError(f'bnrelu_conv2d_same_bwd {shape}: dw '
                                     f'differs between two runs')
            del da, dw, ref_da, ref_dw
        del x, gy
        torch.cuda.empty_cache()
    # max-pool: a compare and a copy (forward), a compare and a select
    # (backward), bit-exact, on tie-heavy input (every padded frame ties);
    # the library calls: max_pool2d and its backward with the indices
    for f, c in pools:
        x = randn(BATCH, FRAMES, f, c).to(torch.bfloat16)
        x[:, FRAMES - 100:] = 0.
        gy = randn(BATCH, FRAMES, f // 2, c).to(torch.bfloat16)
        n = BATCH * FRAMES * f * c
        xn, gyn = _nchw(x), _nchw(gy)
        got = maxpool_freq2(x)
        ref = maxpool_freq2_plain(x)
        torch.cuda.synchronize()
        _check('maxpool_freq2', (BATCH, FRAMES, f, c), got, ref, 0.,
               cuda_ms(lambda: maxpool_freq2(x)),
               cuda_ms(lambda: maxpool_freq2_plain(x)),
               records['maxpool_freq2'], label,
               cuda_ms(lambda: F.max_pool2d(xn, (1, 2))),
               bound(2 * n + n, 0., n / 2))
        got = maxpool_freq2_bwd(x, gy)
        ref = maxpool_freq2_bwd_plain(x, gy)
        torch.cuda.synchronize()
        _, idx = F.max_pool2d(xn, (1, 2), return_indices=True)
        _check('maxpool_freq2_bwd', (BATCH, FRAMES, f, c), got, ref, 0.,
               cuda_ms(lambda: maxpool_freq2_bwd(x, gy)),
               cuda_ms(lambda: maxpool_freq2_bwd_plain(x, gy)),
               records['maxpool_freq2_bwd'], label,
               cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                   gyn, xn, [1, 2], [1, 2], [0, 0], [1, 1], False, idx)),
               bound(2 * n + n + 2 * n, 0., n / 2))
        del idx
    # the residual average pool (F, C -> F / 2, 2C): an add and an exact
    # halving, bit-exact; the library calls: avg_pool2d and its backward
    # (without the channel pad)
    for f, c in crossings:
        x = randn(BATCH, FRAMES, f, c).to(torch.bfloat16)
        gy = randn(BATCH, FRAMES, f // 2, 2 * c)
        shape = (BATCH, FRAMES, f, c, 2 * c)
        n = BATCH * FRAMES * f * c
        xn, gyn = _nchw(x), _nchw(gy[..., :c].to(x.dtype))
        got = avgpool_freq2(x, 2 * c)
        ref = avgpool_freq2_plain(x, 2 * c)
        torch.cuda.synchronize()
        _check('avgpool_freq2', shape, got, ref, 0.,
               cuda_ms(lambda: avgpool_freq2(x, 2 * c)),
               cuda_ms(lambda: avgpool_freq2_plain(x, 2 * c)),
               records['avgpool_freq2'], label,
               cuda_ms(lambda: F.avg_pool2d(xn, (1, 2))),
               bound(2 * n + 4 * n, 0., n))
        got = avgpool_freq2_bwd(gy, c, x.dtype)
        ref = avgpool_freq2_bwd_plain(gy, c, x.dtype)
        torch.cuda.synchronize()
        _check('avgpool_freq2_bwd', shape, got, ref, 0.,
               cuda_ms(lambda: avgpool_freq2_bwd(gy, c, x.dtype)),
               cuda_ms(lambda: avgpool_freq2_bwd_plain(gy, c, x.dtype)),
               records['avgpool_freq2_bwd'], label,
               cuda_ms(lambda: torch.ops.aten.avg_pool2d_backward(
                   gyn, xn, [1, 2], [1, 2], [0, 0], False, True, None)),
               bound(4 * n + 2 * n, 0., n))
    # GRU: same bf16 rounding points on both sides; the recurrence carries
    # accumulation-order differences through T steps. Bound: the
    # kernel-vs-scan drift measured for the TPU kernel, 5.3e-3 (forward),
    # 5.3e-3 * max|ref| (backward). Forward at every serving shape,
    # backward at the training step's (B clips), the fused backward there
    # too, against its own plain version and against the split kernel's
    # dw_hh/db_hh (the two differ in where dgates_n rounds). No PyTorch
    # call computes the recurrence alone (cuDNN's GRU adds the input
    # projection): no library time.
    for d, b, t, h in grus:
        xw = randn(d, b, t, 3 * h).to(torch.bfloat16)
        w_hh = randn(d, h, 3 * h, scale=h ** -.5)
        b_hh = randn(d, 3 * h, scale=.1)
        h0 = torch.zeros(d, b, h, device=dev)
        y = gru_scan(xw, w_hh, b_hh, h0)
        ref = gru_scan_plain(xw, w_hh, b_hh, h0)
        torch.cuda.synchronize()
        _check('gru_scan', (d, b, t, h), y, ref, 5.3e-3,
               cuda_ms(lambda: gru_scan(xw, w_hh, b_hh, h0), reps=5),
               cuda_ms(lambda: gru_scan_plain(xw, w_hh, b_hh, h0), reps=3,
                       warmup=1),
               records['gru_scan'], label, None, gru_work(d, b, t, h))
        del ref
        if b == BATCH:
            g = randn(d, b, t, h, scale=1e-2)
            args = (xw, w_hh, b_hh, h0, y, g)
            for split, name in ((True, 'gru_scan_bwd'),
                                (False, 'gru_scan_bwd_fused')):
                grads = gru_scan_bwd(*args, split=split)
                refs = gru_scan_bwd_plain(*args, split=split)
                torch.cuda.synchronize()
                k_ms = cuda_ms(lambda: gru_scan_bwd(*args, split=split),
                               reps=5)
                p_ms = cuda_ms(lambda: gru_scan_bwd_plain(*args, split),
                               reps=3, warmup=1)
                for i, part in enumerate(('dxw', 'dw_hh', 'db_hh', 'dh0')):
                    _check(f'{name} {part}', (d, b, t, h), grads[i], refs[i],
                           5.3e-3 * float(refs[i].float().abs().max()),
                           k_ms if i == 0 else 0., p_ms if i == 0 else 0.,
                           records[name], label, None,
                           gru_work(d, b, t, h, True) if i == 0 else None)
                if split:
                    split_grads = grads
                else:
                    # the fused kernel against the split one: dxw and dh0
                    # from the same sweep (bit-exact); dw_hh and db_hh
                    # within the backward's bound
                    for i, part in enumerate(('dxw', 'dw_hh', 'db_hh',
                                              'dh0')):
                        a, r = grads[i], split_grads[i]
                        tol = (0. if part in ('dxw', 'dh0') else
                               5.3e-3 * float(r.float().abs().max()))
                        err = float((a.float() - r.float()).abs().max())
                        log(f'{name} vs split kernel {part} {(d, b, t, h)}:'
                            f' max|d|={err:.3e} tol={tol:.3e}')
                        if err > tol:
                            raise AssertionError(
                                f'{name} {part}: fused and split kernels '
                                f'differ by {err} > {tol}')
                    again = gru_scan_bwd(*args, split=False)
                    if not all(torch.equal(a, r)
                               for a, r in zip(grads, again)):
                        raise AssertionError(f'{name}: two runs differ')
                del grads, refs
            del split_grads, g, args
        del xw, y
        torch.cuda.empty_cache()


def check_1x1():
    """The deep tower's 1x1 convs (F, C -> C), the bf16 matmul with the
    bias inside its rounding that ``ops/cnn.py:Conv2d`` runs for them,
    forward and backward through autograd against the plain conv: y and
    dx within one bf16 ulp (2^-7 of max|ref|) as for the conv kernel; dw
    rounded to bf16 as the JAX package rounds it, also 2^-7 of max|ref|."""
    from pb_sed_tpu_torch.ops.cnn import Conv2d
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    for f, c in ((128, 32), (64, 64), (32, 128), (16, 256), (8, 512)):
        conv = Conv2d(c, c, (1, 1)).to(dev)
        with torch.no_grad():
            conv.kernel.copy_(randn(1, 1, c, c, scale=c ** -.5))
            conv.bias.copy_(randn(c, scale=.1))
        x = randn(BATCH, FRAMES, f, c).to(torch.bfloat16).requires_grad_()
        gy = randn(BATCH, FRAMES, f, c, scale=1e-3).to(torch.bfloat16)
        w, b = conv.kernel.detach(), conv.bias.detach()
        ref = conv2d_same_plain(x.detach(), w, b)
        ref_dx, ref_dw = conv2d_same_bwd_plain(x.detach(), w, gy)
        y = conv(x)
        dx, dw = torch.autograd.grad(y, (x, conv.kernel), gy)
        errs = [float((a.detach().float() - r.float()).abs().max())
                for a, r in ((y, ref), (dx, ref_dx), (dw, ref_dw))]
        tols = [2. ** -7 * float(r.float().abs().max())
                for r in (ref, ref_dx, ref_dw)]
        if any(e > t for e, t in zip(errs, tols)):
            raise AssertionError(f'1x1 conv ({f}, {c}): max|d| y, dx, dw '
                                 f'{errs} > {tols}')
        both = cuda_ms(lambda: torch.autograd.grad(conv(x), (x, conv.kernel),
                                                   gy), reps=5)
        log(f'1x1 conv (32, 500, {f}, {c} -> {c}) as a bf16 matmul: '
            f'max|d| y, dx, dw {", ".join(f"{e:.3e}" for e in errs)} '
            f'(tol {", ".join(f"{t:.3e}" for t in tols)}); fwd+bwd '
            f'{both:.3f} ms')
        del x, gy, ref, ref_dx, y, dx


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


def _random_flat(config):
    """Seeded random weights for ``config``'s CRNN in the JAX flat layout,
    passed once through the bridge (``bridge.random_flat``, ``load_flat``,
    ``export_flat``)."""
    from pb_sed_tpu_torch import bridge
    from pb_sed_tpu_torch.models.weak_label import CRNN
    template = CRNN.from_config(CRNN.get_config(config), device='cpu')
    template.load_state_dict(bridge.random_flat(template.state_dict(),
                                                seed=0))
    return template.state_dict()


def _model(config, flat, device='cpu'):
    from pb_sed_tpu_torch.models.weak_label import CRNN
    model = CRNN.from_config(CRNN.get_config(config), device='cpu')
    model.load_state_dict(flat)           # bridge.load_flat
    return model.to(device)


def _config(net, k, fuse_bn=False, augment=True, strong=1.):
    """``fbcrnn_config(net)`` at full width with ``k`` classes, the 2-D
    tower's ``fuse_bn`` set as asked (the weights do not depend on it)."""
    from pb_sed_tpu_torch.models.net_configs import fbcrnn_config
    config = fbcrnn_config(net, num_events=k, augment=augment,
                           strong_fwd_bwd_loss_weight=strong)
    config['cnn']['cnn_2d']['fuse_bn'] = fuse_bn
    return config


def _serve(model, methods, batches, k, label, kernels=FORWARD):
    """Run ``methods`` (name, function, kwargs) on ``batches`` with the
    launch counters set to 0 first; check that ``kernels`` launched and
    the shapes, finiteness and score range; return (scores by method,
    launches)."""
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
        clips = len(batches) * BATCH
        log(f'{label} {name}: {clips} clips in {dt:.3f} s = '
            f'{clips / dt:.1f} clips/s (host clock, inference engine '
            f'included)')
    launches = dict(build.LAUNCHES)
    log(f'launches in the {label} served run: {launches}')
    log(f'peak device memory ({label} serving): '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f'kernel {name} never launched on the '
                                 f'{label} served path')
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
    log(f'{label}: shapes, finiteness and score range: ok')
    return results, launches


def _agree_with_cpu(cpu_model, methods, results, batch):
    """The same model on the CPU (plain versions) for the first two clips
    of ``batch``; tolerance atol = 1e-4 + 3e-2 * max|ref| (bf16 paths that
    round at different points)."""
    first = {key: val[:2] for key, val in batch.items()}
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


def phase_slice():
    """The full-width shallow FBCRNN served on the card through the
    inference engine; returns the kernels' launch counts of that run."""
    from pb_sed_tpu_torch.models import base
    config = _config('shallow', 10)
    flat = _random_flat(config)
    model = _model(config, flat, 'cuda')
    log(f'FBCRNN shallow: {model.num_parameters()} parameters, '
        f'{len(flat)} flat tensors')
    batches = _synthetic_batches(model.module.feature_extractor.stft)
    methods = _methods(base)
    results, launches = _serve(model, methods, batches, 10, 'shallow')
    _agree_with_cpu(_model(config, flat), methods, results, batches[1])
    return launches


def phase_deep_serving():
    """The full-width deep FBCRNN served on the card: tagging of 3 x 32
    clips by the 527-class AudioSet model, SED at window 51 / shift 1 of
    one batch by a 10-class model (the DESED fine-tune's shape), both
    compared with the CPU on the batch of unequal lengths; returns the
    launch counts of both runs together and the 527-class tags."""
    from pb_sed_tpu_torch.models import base
    launches = {name: 0 for name in KERNELS}
    tags = None
    for k, methods, served in ((527, _methods(base)[:1], slice(0, 3)),
                               (10, _methods(base)[2:3], slice(1, 2))):
        config = _config('deep', k)
        flat = _random_flat(config)
        model = _model(config, flat, 'cuda')
        log(f'FBCRNN deep, {k} classes: {model.num_parameters()} '
            f'parameters, {len(flat)} flat tensors')
        batches = _synthetic_batches(model.module.feature_extractor.stft)
        results, counts = _serve(model, methods, batches[served], k,
                                 f'deep/{k}')
        for name, count in counts.items():
            launches[name] += count
        _agree_with_cpu(_model(config, flat), methods, results, batches[1])
        tags = results['tagging'] if k == 527 else tags
        del model
        torch.cuda.empty_cache()
    return launches, tags


def phase_fuse_bn_serving(unfused_tags):
    """Phase 6, served: the deep AudioSet model with ``fuse_bn`` on the
    same weights and the same 3 x 32 clips as phase 5's tagging; the tags
    must agree with the unfused model's (atol 1e-4 + 3e-2 * max|ref|: the
    towers differ in the affine's association and its rounding points)
    and with the CPU. Each forward launches the fused conv at the 8
    fused layers (L2-L16) and the plain conv at L0 only."""
    from pb_sed_tpu_torch.models import base
    config = _config('deep', 527, fuse_bn=True)
    flat = _random_flat(config)
    model = _model(config, flat, 'cuda')
    fused = sorted(model.module.cnn.cnn_2d.fused)
    log(f'FBCRNN deep fuse_bn: fused layers {fused}')
    if fused != list(range(2, 17, 2)):
        raise AssertionError(f'fused layers {fused} != L2-L16')
    batches = _synthetic_batches(model.module.feature_extractor.stft)
    methods = _methods(base)[:1]
    results, launches = _serve(model, methods, batches, 527,
                               'deep_fuse_bn/527', FORWARD + FUSED[:1])
    forwards = len(batches)
    if (launches['conv2d_same'] != forwards
            or launches['bnrelu_conv2d_same'] != 8 * forwards):
        raise AssertionError(f'{forwards} forwards launched conv2d_same '
                             f'{launches["conv2d_same"]} and '
                             f'bnrelu_conv2d_same '
                             f'{launches["bnrelu_conv2d_same"]} times, not '
                             f'1 and 8 each')
    worst = 0.
    for clip, ref in unfused_tags.items():
        got = results['tagging'][clip]
        err = float(np.abs(got - ref).max())
        tol = 1e-4 + 3e-2 * float(np.abs(ref).max())
        worst = max(worst, err / tol)
        if not err <= tol:
            raise AssertionError(f'{clip}: fuse_bn and unfused tags differ '
                                 f'by {err} > {tol}')
    log(f'deep fuse_bn vs unfused tags, {len(unfused_tags)} clips: worst '
        f'max|d|/tol {worst:.3f}')
    _agree_with_cpu(_model(config, flat), methods, results, batches[1])
    del model
    torch.cuda.empty_cache()
    return launches


def phase_shallow_fuse_bn():
    """The shallow recipe with ``fuse_bn`` (fused layers L1-L8): one batch
    of 32 clips tagged (vs the CPU), ``Trainer.train`` for 2 steps, the
    card-vs-CPU step. Returns the launch counts of the served and the
    training run."""
    from pb_sed_tpu_torch.models import base
    from pb_sed_tpu_torch.train.optimizer import Adam
    from pb_sed_tpu_torch.train.trainer import Trainer
    config = _config('shallow', 10, fuse_bn=True)
    flat = _random_flat(config)
    model = _model(config, flat, 'cuda')
    fused = sorted(model.module.cnn.cnn_2d.fused)
    if fused != list(range(1, 9)):
        raise AssertionError(f'shallow fused layers {fused} != L1-L8')
    batches = _synthetic_batches(model.module.feature_extractor.stft)
    methods = _methods(base)[:1]
    results, served = _serve(model, methods, batches[1:2], 10,
                             'shallow_fuse_bn', FORWARD + FUSED[:1])
    _agree_with_cpu(_model(config, flat), methods, results, batches[1])

    def make_model(augment):
        return _model(_config('shallow', 10, fuse_bn=True, augment=augment),
                      flat)

    stft = model.module.feature_extractor.stft
    train = _train_batches(stft, 2, BATCH, 10, seed=5)
    trainer = Trainer(model, optimizer=Adam(lr=5e-4),
                      stop_trigger=(2, 'iteration'))
    torch.cuda.synchronize()
    build.reset_launches()
    trainer.train(train)
    torch.cuda.synchronize()
    trained = dict(build.LAUNCHES)
    log(f'launches in the shallow fuse_bn training run (2 steps): '
        f'{trained}')
    for name in SHALLOW + FUSED:
        if trained[name] <= 0:
            raise AssertionError(f'kernel {name} never launched in the '
                                 f'shallow fuse_bn training run')
    loss = float(trainer.train_step(train[0]))
    if not np.isfinite(loss):
        raise AssertionError(f'shallow fuse_bn loss {loss}')
    del trainer, model
    torch.cuda.empty_cache()
    _card_vs_cpu(make_model, stft, 10)
    return served, trained


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


def bn_fed_biases(module):
    """Conv biases whose output reaches the loss only through a
    training-mode batch norm (pre-activation towers): their gradient is
    identically zero in exact arithmetic. In a tower, conv i feeds norm
    i + 1 unless its output reaches the tower's end along residual skips;
    the 2-D tower's end feeds the 1-D tower's first norm; the output nets'
    first conv feeds their norm."""
    fed = {f'rnn_{d}.output_net.conv_0.bias' for d in ('fwd', 'bwd')}
    for name, tower, end_fed in (('cnn_2d', module.cnn.cnn_2d, True),
                                 ('cnn_1d', module.cnn.cnn_1d, False)):
        n = len(tower.out_channels)
        reaches = [False] * n
        for i in reversed(range(n)):
            j = tower.residuals[i]
            reaches[i] = i == n - 1 or (j is not None and reaches[j])
        fed |= {f'cnn.{name}.conv_{i}.bias' for i in range(n)
                if end_fed or not reaches[i]}
    return fed


def _card_vs_cpu(make_model, stft, k):
    """One B=4, T=100 step, augmentation off, on the card and on the CPU
    (plain versions). The loss within 1e-4 + 3e-2 * |ref|. The CPU's own
    noise is the largest gap between its step and three CPU steps on the
    same clips in other batch orders (the same function; bf16 roundings
    through the training-mode norms move the tower's gradients by ~25%
    there, cosine ~0.96). Each gradient tensor of 16 or more entries
    that is not a norm-fed bias (:func:`bn_fed_biases`) lies within
    1e-4 + 3.5e-2 * max|ref| or three times that noise. The entry norm's
    two scalars and the norm-fed biases (an identically zero gradient)
    are printed only: a single sum that cancels to near zero has no
    stable noise estimate. All gradients together agree with the CPU's
    at a cosine no more than 0.02 below the lowest cosine between the
    CPU's own batch orders."""
    batch = _train_batches(stft, 1, 4, 2, seed=3, k=k)[0]
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
    bn_fed = bn_fed_biases(model.module)
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
        checked = ref.numel() >= 16 and name not in bn_fed
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


def _profile_step(trainer, batch, label):
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
            'maxpool_freq2', 'avgpool_freq2')
    mine = sum(ms for ms, key, _ in rows if any(k in key for k in ours))
    log(f'{label} profiled step: wall {wall:.1f} ms (profiler on), kernels '
        f'busy {total:.1f} ms (idle share {100 * (1 - total / wall):.0f}%), '
        f'hand-written kernels {mine:.1f} ms '
        f'({100 * mine / max(total, 1e-9):.0f}% of busy)')
    for ms, key, count in rows[:15]:
        log(f'  {ms:8.2f} ms  x{count:<5d} {key[:90]}')


# Trainer settings per recipe: classes, Adam, strong loss weight. Deep:
# the AudioSet recipe (experiments/weak_label_crnn/training.py:118-151).
_DEEP_RECIPE = {'net': 'deep', 'k': 527,
                'adam': {'lr': 1e-4, 'gradient_clipping': .1}, 'strong': 0.}
RECIPES = {
    'shallow': {'net': 'shallow', 'k': 10, 'adam': {'lr': 5e-4},
                'strong': 1., 'fuse_bn': False, 'kernels': SHALLOW},
    'deep': dict(_DEEP_RECIPE, fuse_bn=False, kernels=DEEP),
    'deep_fuse_bn': dict(_DEEP_RECIPE, fuse_bn=True, kernels=DEEP + FUSED),
}


def phase_training(recipe_name='shallow'):
    """The full-width FBCRNN of recipe ``recipe_name`` trained on the card
    through ``Trainer``; returns the kernels' launch counts of that run
    and its steps/s, clips/s and peak device memory."""
    from pb_sed_tpu_torch.models import base
    from pb_sed_tpu_torch.models.weak_label import CRNN
    from pb_sed_tpu_torch.train.hooks import LRAnnealingHook
    from pb_sed_tpu_torch.train.optimizer import Adam
    from pb_sed_tpu_torch.train.trainer import Trainer
    from pb_sed_tpu_torch.utils.config import config_to_json
    from pb_sed_tpu_torch.utils.misc import dump_json
    recipe = RECIPES[recipe_name]

    def config(augment):
        return _config(recipe['net'], recipe['k'], recipe['fuse_bn'],
                       augment, recipe['strong'])

    flat = _random_flat(config(True))

    def make_model(augment):
        return _model(config(augment), flat)

    model = make_model(augment=True).to('cuda')
    stft = model.module.feature_extractor.stft
    batches = _train_batches(stft, 4, BATCH, 10, seed=1, k=recipe['k'])
    step_log = _StepLog()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, optimizer=Adam(**recipe['adam']),
                          storage_dir=tmp,
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
        log(f'launches in the {recipe_name} training run: {launches}')
        for kernel in recipe['kernels']:
            if launches[kernel] <= 0:
                raise AssertionError(f'kernel {kernel} never launched in '
                                     f'the {recipe_name} training run')
        log(f'{recipe_name} loss per step: ' + ', '.join(
            f'{x:.5f}' for x in step_log.losses))
        if len(step_log.losses) != TRAIN_STEPS or not np.isfinite(
                step_log.losses).all():
            raise AssertionError(f'training losses: {step_log.losses}')
        steps = np.diff(step_log.times)
        steady = steps[2:]  # steps 1-2: cuBLAS/cuFFT plans, allocator
        log(f'{recipe_name} step times (host clock, synchronized): '
            + ', '.join(f'{1e3 * x:.1f}' for x in steps) + ' ms')
        metrics = {'steps_per_s': 1 / steady.mean(),
                   'clips_per_s': BATCH / steady.mean(),
                   'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30}
        log(f'{recipe_name} training: {metrics["steps_per_s"]:.3f} steps/s = '
            f'{metrics["clips_per_s"]:.1f} clips/s over steps 3-'
            f'{TRAIN_STEPS} (batch {BATCH} x 10 s clips, augmentation '
            f'on, host clock)')
        log(f'peak device memory ({recipe_name} training): '
            f'{metrics["peak_gib"]:.2f} GiB')
        with open(f'{tmp}/summary.jsonl') as fid:
            summary = [json.loads(line) for line in fid]
        log(f'summary.jsonl: {len(summary)} lines, last {summary[-1]}')

        # the checkpoint restores and serves
        dump_json({'trainer': {'model': config_to_json(
            CRNN.get_config(config(True)))}}, f'{tmp}/1/config.json')
        restored = CRNN.from_storage_dir(
            tmp, checkpoint_name='ckpt_latest.pkl', device='cuda')
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
        _profile_step(trainer, batches[0], recipe_name)
    del trainer, model, restored
    torch.cuda.empty_cache()

    # the loss falls on a repeated batch (augmentation off)
    model = make_model(augment=False).to('cuda')
    trainer = Trainer(model, optimizer=Adam(lr=1e-3))
    losses = [float(trainer.train_step(batches[1])) for _ in range(5)]
    log(f'{recipe_name} repeated batch, augmentation off: loss ' + ', '.join(
        f'{x:.5f}' for x in losses))
    if not losses[-1] < losses[0]:
        raise AssertionError(f'the loss did not fall: {losses}')
    del trainer, model
    torch.cuda.empty_cache()
    _card_vs_cpu(make_model, stft, recipe['k'])
    return launches, metrics


def main():
    card = phase_card()
    records = {name: new_record() for name in KERNELS}
    log('TF32 off for cuDNN and cuBLAS (plain versions in full f32)')
    build.reset_launches()
    check_kernels(records, 'shallow', 0, CONV_LAYERS, POOLS, GRU_SHAPES,
                  fused=[name for name, *_ in CONV_LAYERS[1:]])
    check_kernels(records, 'deep', 2, DEEP_CONV_LAYERS, DEEP_POOLS,
                  DEEP_GRU_SHAPES, DEEP_CROSSINGS,
                  fused=[name for name, *_ in DEEP_CONV_LAYERS[1:]])
    kernel_phase = dict(build.LAUNCHES)
    check_1x1()
    launches = {'shallow_serving': phase_slice()}
    launches['shallow_training'], _ = phase_training('shallow')
    launches['deep_serving'], unfused_tags = phase_deep_serving()
    launches['deep_training'], unfused = phase_training('deep')
    launches['deep_fuse_bn_serving'] = phase_fuse_bn_serving(unfused_tags)
    launches['deep_fuse_bn_training'], fused = phase_training('deep_fuse_bn')
    log('deep training, unfused vs fuse_bn (B=32, steps 3-8, host clock): '
        + ', '.join(f'{key} {unfused[key]:.3f} vs {fused[key]:.3f}'
                    for key in ('steps_per_s', 'clips_per_s', 'peak_gib')))
    (launches['shallow_fuse_bn_serving'],
     launches['shallow_fuse_bn_training']) = phase_shallow_fuse_bn()
    launches['kernel_phase'] = kernel_phase
    kernels = []
    for name in KERNELS:
        rec = records[name]
        side = ('bytes' if rec['bound_bytes_ms'] >= rec['bound_operations_ms']
                else 'operations')
        kernels.append({
            'name': name, **KERNELS[name],
            'launches': launches[MAIN_PATH[name]][name],
            'launches_from': MAIN_PATH[name],
            'launches_by_path': {path: counts[name]
                                 for path, counts in launches.items()},
            'max_abs_err': rec['max_abs_err'],
            'ms': _total(rec['shallow_ms'], rec['deep_ms']),
            'plain_ms': _total(rec['shallow_plain_ms'],
                               rec['deep_plain_ms']),
            'bound_ms': rec['bound_ms'], 'bound_by': side,
            'library_ms': rec['library_ms'],
            **{key: rec[key] for key in (
                'shallow_ms', 'shallow_plain_ms', 'shallow_library_ms',
                'deep_ms', 'deep_plain_ms', 'deep_library_ms')}})
    print(card)                           # nvidia-smi name, power.limit
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
