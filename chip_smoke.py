"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``pb_sed_tpu_torch/csrc`` and
runs, in order:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA
   versions, kernel build time, each kernel's registers, shared memory
   and spills (``-Xptxas -v``) and ptxas's performance advisories; the
   C++ wav reader's build (``g++``, host code).
   Without a CUDA card it raises: there is no CPU path.
2, 2b. kernel vs plain: every kernel, forward (2) and backward (2b),
   against its plain PyTorch version on the card at the shapes the
   full-width shallow FBCRNN gives it (B=32 ten-second clips), with
   max|delta| against the stated tolerance, median CUDA-event times of
   both and of one PyTorch library call that computes the same function
   where there is one (cuDNN's bf16 channels-last conv and its backward,
   the max and average pools, cuDNN's bf16 GRU with identity input
   weights, timed also without that identity product, with its max|delta|
   against the plain GRU), and the least time the card could take
   (bytes at 3.35 TB/s or operations at 989 TFLOP/s bf16 / 67 TFLOP/s
   f32, whichever is larger). The BN+ReLU-fused conv and its backward
   run at the shallow tower's fused layers L1-L8, with a scale and shift
   that make about half the pre-activations negative and the shift often
   positive (a lit SAME halo or a wrong gate shows). Per conv layer one
   line says which design ran for each pass (the wgmma kernels of
   ``csrc/conv2d_wgmma.cuh`` or the entry kernels of
   ``csrc/conv2d_entry.cuh`` with their ring depth and shared memory;
   from Cin = 16 up anything but wgmma with a ring of >= 3 stages (2
   where two blocks share an SM) fails the run, below 16 anything but the entry kernels for the forward and
   dw and the wgmma one for dx), the achieved TFLOP/s
   beside cuDNN's time and the bound, and the backward's device time by
   launch (dx GEMM, dw partials, reduce, glue; ``torch.profiler``); at an
   entry layer (Cin < 16) a line more with the entry forward's, the dx
   GEMM's (N = Cin on the wgmma kernel, against cuDNN's dgrad: the
   input's gradient alone) and the dw
   pass's device time without dx (``need_dx=False``; its dw equal in
   every bit to the dw with dx), each beside its bound, its share of the
   bound and cuDNN's device time; after the kernel phases,
   the per-layer record as JSON and the sums over both towers. The pools
   are timed by replaying a CUDA graph of 10 calls (one call of the
   max-pool forward timed on an idle card is logged beside it). Per GRU
   shape one line per pass says which design ran (w_hh resident in a
   thread-block cluster's shared memory, ``csrc/gru_cluster.cuh``, with
   the cluster's size, its rows, the shared memory a block and the
   clusters the card holds at once; or the row-tiled kernels) and one
   gives the wrapper's ms, the kernel's alone, its time per serial step
   and the row-tiled kernel's ms of before; at the training shape
   (2, 32, 500, H) anything but the cluster design fails the run (the
   fused backward's too), as does a spill in a cluster kernel, a second
   run of a GRU backward that differs in any bit, or a fused backward
   whose dxw or dh0 differs from the split one's in any bit. After the
   kernel phases: the max-pool forward's share of its bound over the 8
   pools, the fused GRU backward's wrapper time against the split one's
   at the two training shapes, and cuDNN's GRU times per shape as JSON.
   The GRU forward also runs at the two shapes that only the tuning chain
   (phase 8) gives it: (2, 8 000, 11, 256), the shortest SED window over
   16 clips (row-tiled), and (2, 32, 250, 256), scenario 2's window of 250
   at shift 250 (the cluster design); held against its plain version,
   its times printed and left out of the kernels line's sums. So do the
   shapes only the strong-label BiCRNN gives the kernels (phase 9): the
   tag-conditioned entry conv at 11 input channels, (32, 500, 128, 11 ->
   16), forward, dx and dw, with its design, cuDNN's time and its bound,
   and the GRU forward at (2, 16, 500, 256), a strong tuning batch.
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
   gradient); one step is profiled (device time by kernel family and
   the 15 largest kernels); the checkpoint restores with
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

7. the training entry point, from wav files on disk: a DESED-shaped
   database is written from a seed into a temporary directory (16 kHz
   mono int16 wav files of ten seconds, a few shorter, with tone-burst
   events of ten classes; ``train_weak``, ``train_strong``,
   ``train_synthetic20``, ``train_synthetic21`` and ``validation``), and
   ``experiments.weak_label_crnn.training.ex.run`` trains the full-width
   shallow FBCRNN on it with the DESED recipe (batch 32, two prefetch
   workers, time warp, mixing and augmentation on) for 16 iterations with
   a checkpoint every 8 (a ramp of 4 steps instead of the recipe's 1000,
   so that 16 steps move the loss): ``test_run``, validations and the best
   checkpoint happen. Every shallow kernel's launch counter must rise, the
   loss be finite at every step and lower over the last 4 steps than the
   first 4, ``summary.jsonl`` hold validation lines with a finite
   ``macro_fscore_weak``, and ``ckpt_best_macro_fscore_weak.pkl`` load
   through ``CRNN.from_storage_dir`` on the card and tag a batch with
   scores in [1e-5, 1 - 1e-5]. A second run starts from that checkpoint
   (``init_ckpt_path``, 4 iterations, gradient clipping 1), a third
   resumes it for 4 more. The device time warp is held against the CPU's
   on one batch of the loader. Printed: the run's steps/s over iterations
   3-16 (validation taken out) beside phase 4's on in-memory batches, the
   seconds in ``validate``, the host seconds per batch of the loader
   alone, peak device memory.
8. the tuning and inference chain, inside phase 7's directory: 32
   ``eval_public`` clips with onsets and offsets join its database, and
   ``experiments.weak_label_crnn.tuning.ex.run`` tunes on its 32
   validation clips with the recipe's grids (``num_jobs=8``, batches of
   16 as the training CLI's chain passes them) the ensemble of phase 7's
   two runs (their best checkpoints; the first alone if the second has
   none), on the card: tagging thresholds, boundary step filters, SED
   windows and median filters for PSDS scenarios 1 and 2, chained into
   inference on ``eval_public`` for both scenarios; then one more
   inference run saves scores and detections and pseudo-labels weakly
   and strongly. It fails on a missing hyper-parameter file, a threshold
   outside [0, 1] (an end of the sweep, +-inf, is the reference's answer
   where no threshold qualifies), a length outside its grid, a non-finite
   F-score, PSDS or AUC (over its max eFPR of 100) or one outside [0, 1],
   a PSDS from the saved score files other than the in-memory one, no
   pseudo-labeled database json, a forward kernel that did not launch or
   a backward kernel that did. Printed: a pool's start under ``spawn``
   and ``forkserver``; per run the host seconds in the inference engine
   (model calls and their score frames) and in evaluation, the pools and
   their start seconds, peak memory, clips/s of each engine call; all of
   it as JSON.

9. the strong-label side. 9a, in memory: the full-width tag-conditioned
   shallow BiCRNN (``bicrnn_config('shallow', tag_conditioning=True)``,
   random weights from a seed, through the bridge) serves the 3 x 32
   clips of phase 3 with seeded tags through ``models.base``'s tagging and
   sound event detection (checked like phase 3; a tag is the max of the
   clip's valid frames), trains for 8 steps with the DESED strong recipe's
   settings (strong targets with soft frames, tags as the condition;
   phase 4's checks, steps/s beside phase 4's FBCRNN numbers), and the
   AudioSet strong configuration (456 classes, no conditioning,
   ``eval_segment_length`` 50, clipping 0.1) takes 2 steps. 9b, inside
   phase 7-8's directory: 32 ``train_unlabel_in_domain`` clips (written
   with phase 7's database, after its other sets) are pseudo-labeled
   weakly and strongly by a weak inference run from phase 8's
   hyper-parameters; on that json
   ``experiments.strong_label_crnn.training.ex.run`` trains the BiCRNN
   with the DESED recipe (batch 32, two prefetch workers,
   ``train_unlabel_in_domain: 2``) for 16 iterations, a checkpoint and a
   validation every 8 (a ramp of 4), chained into the strong tuning (the
   recipe's 12 median filters, ``num_jobs=8``, batch 16, phase 8's weak
   ensemble tagging) and inference on ``eval_public`` (sets f and psds1);
   then inference for psds2, and one with score and detection files and
   strong pseudo-labels of ``train_unlabel_in_domain``. It fails on a
   non-finite loss, no validation line with a finite
   ``macro_fscore_strong``, a best checkpoint that is missing or does not
   serve on the card, a missing hyper-parameter file, a median filter
   outside the grid or a threshold outside [0, 1] (beyond the ends of its
   sweep), a metric outside [0, 1], a missing TSV or a wrong TSV header,
   a forward kernel that did not launch after training or a backward one
   that did. Printed: steps/s over iterations 3-16, host seconds in tuning
   and inference (engine and evaluation), pools, clips/s of each engine
   call, peak memory; all of it as JSON.

10. the stacked ensemble (``models/base/ensemble.py``). 10a: the
   member-axis conv forward, plain and BN+ReLU-fused, at the shallow
   tower's shapes with 10 members and the deep tower's with 3 (L0 on the
   entry kernel, asserted): ONE launch must equal M single launches in
   every bit and lie within the conv's tolerance of its plain version; per layer
   the ms of the one launch, of M single launches, of the plain version,
   of cuDNN's grouped conv (``groups=M``) and the bound. The GRU forward
   at D = 2N (``ENSEMBLE_GRU_SHAPES``: 10 members' tagging, a tuning
   batch and one SED chunk of windows, and shapes on either side of the
   shape rule's limit) under both designs (``scripts/perf/
   gru_designs.py``), each against its plain version, with the design
   the rule (``gru_cluster_takes``) takes. 10b: 10 shallow FBCRNNs
   (random weights from seeds 0-9) serve phase 3's 3 x 32 clips through
   ``models.base``'s tagging, boundaries detection and SED 51/1, stacked
   (the engine's default, which runs sliding-window SED in chunks of
   ceil(32 / 10) = 4 clips) and with ``auto_stack=False`` (in turn): the
   two agree within 1e-4 + 3e-2 * max|ref| on every clip (the deviation
   logged), clips/s, peak memory and launches a batch of both; the
   stacked lane launches each kernel once per layer and forward whatever
   the members (the in-turn lane's launches over 10, times the chunks).
   Then 3 deep 527-class FBCRNNs tag the clips, plain and ``fuse_bn``,
   checked the same way. Phases 8 and 9b serve their weak ensemble
   stacked by default (each engine call logs it, and a call that served
   an ensemble in turn fails the run). 10c: every stacked GRU forward
   shape (D > 2) that phases 8, 9b and 10b gave the kernel (recorded as
   they ran) is held against the plain version, under the design the
   rule takes there.

11. the Transformer head, dropout, the profiler hook and the multi-step
   lane. 11a: the Transformer-head FBCRNN at the reference's width
   (``fbcrnn_config('shallow')`` with both heads the head's own defaults:
   hidden 256, d_ff 1024, 6 layers, 8 heads, dropout 0.2; weights from
   ``bridge.init_flat`` with a seed) serves phase 3's 3 x 32 clips by
   tagging, boundaries and SED 51/1, checked like phase 3 (the conv
   forward and max-pool counters must rise; within 1e-4 + 3e-2 * max|ref|
   of the CPU); clips/s and peak memory. 11b: the same model takes 8
   ``Trainer`` steps with its heads' dropout 0.2, the towers' 0.1 (no
   layer fuses), augmentation on, and ``profile_at=3,
   profile_num_steps=2`` (steps 3-5 traced, the JAX trainer's rule): the
   loss must be finite and lower over the second pass over the 4 batches
   than the first, the conv pair's and the max-pool pair's counters must
   rise, and the trace under ``<storage_dir>/profile`` must name the
   port's conv forward, conv backward and max-pool kernels. Printed: each
   profiled step's host and device ms from the trace, the step's device
   ms by family (the port's kernels, f32 matmuls, bf16 matmuls, glue),
   steps/s over steps 7-8 and peak memory. 11c: phase 4's shallow GRU
   FBCRNN with dropout 0.1 in both towers and between its GRU layers, from
   the same weights and seeds, takes 8 steps as ``steps_per_call=4`` and
   as 8 single steps (twice): the lane's state must lie within 3x the
   single steps' rerun difference of theirs (0 on the card: it must be
   equal in every bit), its checkpoints at 4 and 8 where the JAX
   trainer's lane puts them (the single steps' at 3, 6, 8), the GRU pair's,
   the conv pair's and the max-pool's counters must rise, and the keep
   rate of every mask the lane drew must lie within 4 sigma of 0.9.

12. the data-preparation path, from a raw tree to training. 12a: phase
   7's sets and tone bursts written from a seed at 44.1 kHz in DESED's
   layout (``audio/<purpose>/<name>/*.wav``, ``metadata/<purpose>/
   <name>.tsv``): 16-bit mono, every eighth clip stereo, every eighth
   24-bit, one ``WAVE_FORMAT_EXTENSIBLE`` file (which the C++ reader
   rejects); the bytes written are printed. 12b: ``python -m
   pb_sed_tpu_torch.database.resample_db -i raw -o db16k -n 8``: every
   output 16 kHz mono int16 of ``resample_poly``'s length, the metadata
   copied byte for byte; a second run skips every file. 12c: ``python -m
   pb_sed_tpu_torch.database.desed.create_json`` on both trees: every set
   and clip with the events, onsets and offsets written, each
   ``audio_length`` within one sample. 12d: the weak training CLI at the
   shallow recipe's full width (batch 32, two prefetch workers,
   augmentation, the default ``AudioReader``, so ``use_native``; no
   validation) takes 8 iterations on db16k's json and 4 on the raw tree's,
   where the loader resamples 44.1 kHz in C++ (every read recorded; only
   the extensible file may go to ``read_wav``): every shallow kernel's
   counter must rise in each run and the loss be finite at every step.
   12e, on the card's host: ``load_wav_batch`` equal to ``load_wav`` in
   every bit, the C++ path within 1.2e-7 of ``read_wav``'s on the 16 kHz
   files; printed: the 44.1 kHz gap to ``resample_poly`` (the JAX
   reader's semantics, no gate), ms a 44.1 kHz clip of both paths and the
   loader's ms a batch with ``use_native`` True and False (A B B A). 12e
   runs before the raw training run, whose prefetch threads outlive it.
   The seconds of 12a-12e and the steps/s of 12d beside phase 7's.

13. the mesh on ``torch.distributed`` (``parallel/mesh.py``; ranks
   spawned by ``parallel/launch.py:run_ranks``, which joins them with a
   deadline and fails with a failing rank's traceback). 13a: a world of
   2 ranks on the one card (gloo, both on cuda:0) trains the full-width
   shallow FBCRNN 4 steps on 4 global batches of 32 ten-second clips (16
   a rank, augmentation on, weights from seed 0) through
   ``Trainer(use_mesh=True)``, against one process taking the same steps
   on the same clips: the loss at each step, every parameter's update and
   every running statistic after step 4, by the looser of the CPU test's
   tolerance and three times the one process's own rounding noise (the
   mean over 5 probes, its steps with every global sum and gradient moved
   by one ulp, the signs from seeds 0-4); both ranks
   end in the same state in every bit and each rank's shallow kernels
   launch. Printed: steps/s of one process and of each rank (a shared
   card, not a scaling number). 13b: a 1-rank world formed by
   ``initialize_distributed`` under torchrun's variables with its default
   backend (NCCL) takes 2 steps. 13c: the 10 shallow members of phase 10
   over the 2-rank world (an ensemble axis of 2, five a rank) tag 2
   batches of 32 and run SED 51/1 on one; every rank's whole scores within
   phase 10's tolerance of one process's stacked output. 13d: the trace
   reader (``utils/trace.py``) on two profiled shallow steps: the device
   ms per step within 1% of ``step_times_ms``'s, the top 10 ops and the 5
   longest idle gaps with the host op behind each. 13e: the device filters
   on CUDA tensors against the numpy filters at the tuning chain's score
   shapes, and whether tensorboardX is there (if so, the event file's
   scalars must equal ``summary.jsonl``'s).
14. the tower configurations beyond the recipes. Right after phase 2c
   (under its own launch count) the kernels of phases 2/2b at phase 14's
   shapes: the max pool of any window, bit-exact, (2, 2) and (1, 2) at
   14a's (32, 500, 128, 16) and (32, 250, 64, 32), the 1-D tower's f32
   time pool at (32, 125, 1, 256) and 14b's (2, 1) pool on F = 5; the
   average pool of 14b's crossing over that pool, (32, 500, 5, 256) ->
   (32, 500, 2, 512), bit-exact (and the row-pair one at its 24 -> 64
   crossing, printed only); the conv and its backward at shapes the
   kernels take padded, Cout 24 at 14b's L0 and L2 and 2 x 2 and 4 x 3
   kernels at (32, 500, 64, 64); each with its bound and a library
   call's time; then 14b's 3x3 layers at F = 40, 20, 10 and 5 (the
   wgmma pair's tiles of whole rows off a power of two), each pass's
   design asserted (entry or wgmma), forward and backward against the
   plain versions, timed beside cuDNN's bf16 calls, each bound and share
   (L0: its dx alone too). After phase 13: 14a, the shallow FBCRNN of the AudioSet
   recipe (527 classes, no strong loss) with time pools ([1, [2, 2], 1,
   [2, 2], 1, [2, 1], 1, [2, 1], 1] in 2-D, [1, 2, 1, 1, 1] in 1-D) and
   ``fuse_bn``, serves 3 batches of 32 ten-second clips by tagging,
   boundaries and SED 51/1 (500 frames pool to 62, a full clip's seq_len
   to 63) and trains 8 steps; 14b, the deep recipe at 40 mel bins (its
   fourth pool meets F = 5, a residual crosses it) with 24 channels in
   its first four 2-D layers, unfused and ``fuse_bn``, tags 3 batches
   and trains 8 steps each (one unfused step profiled by kernel family);
   14c, the shallow recipe without norms and
   with elu, tags 3 batches. Served runs agree with the CPU, trained ones
   pass the card-vs-CPU step (the CPU's noise with its convs summed in
   f64 too); clips/s, steps/s and peak memory beside phases 3-5's.
15. the GRU's hidden widths and ``compute_dtype='float32'``. Right after
   phase 14's kernels (under its own launch count) 15d: the GRU pair on
   the cluster design of 16 blocks of H / 16 units
   (``csrc/gru_cluster_wide.cuh``) at (2, 32, 500, H) for H = 768, 1024
   and 2048 and (2, 16 000, 51, H) for 768 and 1024, with its units a
   block, rows a cluster, w_hh's resident and streamed KiB and
   co-resident clusters, and at H = 200 (run as 256 on the
   cluster design at the training shape), forward and backward against
   the plain version at the real H (the backward at SED's shapes on its
   first 2 048 rows, which are independent, and timed whole but at 1024,
   where the wrapper's f32 weight-gradient contraction would need ~83 GB),
   with the design each pass runs, cuDNN's GRU and the bound; H = 200's
   forward on the row-tiled kernel at 224 against the cluster at 256
   (``scripts/perf/gru_designs.py``'s ``scan_as``); H = 600 (run as 768)
   beside 768; the f32 conv and its
   backward (``csrc/conv2d_f32.cu``) at the shallow tower's nine 3x3
   shapes against the plain version (cuDNN off), with cuDNN's f32 conv
   (TF32 off) as the library call and its dw's distance from the plain
   version printed; then the recipes' three entry layers (shallow 1 -> 16,
   deep 1 -> 32, BiCRNN 11 -> 16) on the f32 entry kernels
   (``csrc/conv2d_f32_entry.cuh``): forward, dx and dw against the plain
   versions, dw bit-identical on a rerun and without dx, each pass's
   device time beside its bound and cuDNN's f32 call; then 14b's seven
   3x3 layers off a power-of-two F (F = 40, 20, 10, 5) and a layer at
   Cout = 10 (F 40, 24 -> 10) in f32 on the 3xTF32 pair's rows x W tiles
   (the narrow layer padded to 16 channels, its dx from 10 on the entry
   kernels): forward, dx and dw against the plain versions, dw
   bit-identical on a rerun and without dx, each pass's design and
   device time beside its bound and cuDNN's f32 call, and the seven
   layers' sums. After phase 14:
   15a, the shallow FBCRNN with ``compute_dtype='float32'`` in both towers
   and both heads' output nets (L0 on the entry kernels, forward, dx and
   dw; L1-L8 on 3xTF32), serves 3 batches of 32 ten-second clips by
   tagging and SED 51/1 and trains 8 steps; 15b, the shallow FBCRNN with
   both heads at hidden size 768 (the paired D = 2 recurrence above 512),
   the same; 15c, the tag-conditioned BiCRNN at hidden size 200, tags 3
   batches and trains 8 steps; 15e, the tag-conditioned BiCRNN with
   ``compute_dtype='float32'`` in both towers and the output net (its
   Cin = 11 entry layer on the entry kernels), tags 32 clips and trains 4
   steps; 15f, 14b's configuration (the deep recipe at 40 mel bins, 24
   channels in its first four 2-D layers, 527 classes) with
   ``compute_dtype='float32'`` in both towers and the output net (L0 on
   the entry kernels, every other 3x3 layer on 3xTF32 at F = 40 ... 5),
   tags 32 clips and trains 4 steps, its steps/s, clips/s and peak memory
   beside 14b's bf16 run. Served runs agree with the CPU, trained ones pass the
   card-vs-CPU step (the CPU's noise with its bf16 convs and its GRU
   summed in f64 too); clips/s, steps/s and peak memory beside phases
   3-4's.

Each path (shallow serving and training, deep serving and training, the
fused ones, the training entry point, the tuning chain, the strong
serving and training, the strong CLI training and its chain, the stacked
ensembles, the Transformer's serving and training, the multi-step lane,
the data-preparation path's two training runs, each rank's mesh training
and ensemble, the NCCL world's training, phase 14's and phase 15's served
and trained runs) runs with the launch counters set to 0 just before it
and read just after.
Any failure raises (non-zero exit). Before it prints its last lines, or
fails, the run stops every process it started: the evaluation pools'
forkserver and resource tracker, and any other process still below it
(logged). The line before the last is the kernels' JSON record, the last
line ``{"ok": true, "device": ...}``.
"""
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from pb_sed_tpu_torch.data import native
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.conv import (
    avgpool_freq2, avgpool_freq2_bwd, avgpool_freq2_bwd_plain,
    avgpool_freq2_plain, bnrelu_conv2d_same, bnrelu_conv2d_same_bwd,
    bnrelu_conv2d_same_bwd_plain, bnrelu_conv2d_same_members,
    bnrelu_conv2d_same_members_plain, bnrelu_conv2d_same_plain, conv2d_same,
    conv2d_same_bwd, conv2d_same_bwd_plain, conv2d_same_members,
    conv2d_same_members_plain, conv2d_same_plain, conv_designs,
    maxpool_freq2, maxpool_freq2_bwd, maxpool_freq2_bwd_plain,
    maxpool_freq2_plain, avgpool2d, avgpool2d_bwd, avgpool2d_bwd_plain,
    avgpool2d_plain, maxpool2d, maxpool2d_bwd, maxpool2d_bwd_plain,
    maxpool2d_plain)
from pb_sed_tpu_torch.ops.kernels.gru import (gru_designs, gru_scan,
                                              gru_scan_bwd,
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
# (D, B, T, H) that the tuning chain (phase 8, batches of 16 clips) gives
# the GRU beyond those: sliding-window SED at its shortest window, 11
# frames (16 x 500 windows), and scenario 2's window of 250 at shift 250
# (16 clips x 2 windows of 250 steps)
CHAIN_GRU_SHAPES = [(2, BATCH // 2 * FRAMES, 11, 256), (2, BATCH, 250, 256)]
# the shapes only the strong-label BiCRNN (phase 9) gives the kernels: the
# tag-conditioned entry conv (1 mel channel + 10 tag channels), forward and
# backward, and both directions of a bidirectional layer over the 16 clips
# of a strong tuning batch (its training batch of 32 is GRU_SHAPES[0])
STRONG_CONV_LAYERS = [('L0', 128, 11, 16)]
STRONG_GRU_SHAPES = [(2, BATCH // 2, FRAMES, 256)]
# phase 10, the stacked ensemble: 10 shallow FBCRNNs (their convs on the
# member axis at M = 10, their paired heads one GRU at D = 20) and 3 deep
# ones (M = 3, D = 6 at H = 512); sliding-window SED in the engine's
# default chunks of ceil(clips / members) = 4 clips (4 x 500 windows a
# chunk), which hold as many member-clips as one member's 32 in turn
ENSEMBLE_MEMBERS = 10
DEEP_MEMBERS = 3
SED_CHUNK = -(-BATCH // ENSEMBLE_MEMBERS)
# the GRU forward at D = 2N, timed under both designs: tagging (32 clips),
# a tuning batch (16 clips) and one SED chunk of windows at 51 / 1; and
# shapes on either side of the rule's limit of 192 row tiles of 16
# (csrc/gru_cluster.cuh): 180 and 240 tiles at T = 500, 192 and 224 at
# T = 51
ENSEMBLE_GRU_SHAPES = [(2 * ENSEMBLE_MEMBERS, BATCH, FRAMES, 256),
                       (2 * ENSEMBLE_MEMBERS, BATCH // 2, FRAMES, 256),
                       (2 * ENSEMBLE_MEMBERS, SED_CHUNK * FRAMES, 51, 256),
                       (2 * ENSEMBLE_MEMBERS, 144, FRAMES, 256),
                       (2 * ENSEMBLE_MEMBERS, 192, FRAMES, 256),
                       (2, 1536, 51, 256), (2, 1792, 51, 256)]
# The row-tiled GRU kernels' ms at (2, 32, 500, H) before the cluster
# design, kernel alone: the parent tree in `scripts/gru_ab.py
# chip_tmp/parent . --rounds 2` (NVIDIA H100 80GB HBM3, 700.00 W), printed
# beside this run's
EARLIER_GRU_MS = {
    ('fwd', 256): 15.751, ('bwd', 256): 32.225,
    ('fwd', 512): 38.278, ('bwd', 512): 82.779}

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
    # phase 14's paths: the max and average pools of any window, and the
    # conv kernels at the shapes they take padded (Cout off a multiple of
    # 16, Cin >= 16 off a multiple of 8, even extents; those launches
    # count under the pair's names too)
    'maxpool2d': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/maxpool.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:1759'},
    'maxpool2d_bwd': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/maxpool.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:1773'},
    'avgpool2d': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/avgpool.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:1862'},
    'avgpool2d_bwd': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/avgpool.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:1875'},
    'conv2d_same_padded': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/conv2d.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:413, '
                    'pb_sed_tpu/ops/pallas/conv.py:508'},
    'conv2d_same_bwd_padded': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/conv2d_bwd.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:642, '
                    'pb_sed_tpu/ops/pallas/conv.py:552, '
                    'pb_sed_tpu/ops/pallas/conv.py:599'},
    # phase 15's paths: the f32 conv pair of a compute_dtype='float32'
    # tower (no Pallas site: the JAX package's f32 lax.conv_general_dilated
    # and its autodiff), the GRU pair's cluster design above H = 512 (no
    # Pallas site: the JAX package's lax.scan) and the pair at an H it
    # takes padded (those launches count under the pair's names too)
    'conv2d_same_f32': {
        'route': 'cuda',
        'source': 'pb_sed_tpu_torch/csrc/conv2d_f32_wgmma.cuh',
        'replaces': 'pb_sed_tpu/ops/cnn.py:115'},
    'conv2d_same_f32_bwd': {
        'route': 'cuda',
        'source': 'pb_sed_tpu_torch/csrc/conv2d_f32_wgmma.cuh',
        'replaces': 'pb_sed_tpu/ops/cnn.py:115'},
    # the f32 pair's entry kernels (Cin < 16: an f32 tower's first layer):
    # the forward and the backward (dx and dw, with the dw's reduce),
    # counted by the pair's wrappers where they run them; their times are
    # device times (torch.profiler) of each pass at the recipes' three
    # entry layers
    'conv2d_same_f32_entry': {
        'route': 'cuda',
        'source': 'pb_sed_tpu_torch/csrc/conv2d_f32_entry.cuh',
        'replaces': 'pb_sed_tpu/ops/cnn.py:115'},
    'conv2d_same_f32_bwd_entry': {
        'route': 'cuda',
        'source': 'pb_sed_tpu_torch/csrc/conv2d_f32_entry.cuh',
        'replaces': 'pb_sed_tpu/ops/cnn.py:115'},
    'gru_scan_wide': {
        'route': 'cuda',
        'source': 'pb_sed_tpu_torch/csrc/gru_cluster_wide.cuh',
        'replaces': 'pb_sed_tpu/ops/rnn.py:136'},
    'gru_scan_bwd_wide': {
        'route': 'cuda',
        'source': 'pb_sed_tpu_torch/csrc/gru_cluster_wide.cuh',
        'replaces': 'pb_sed_tpu/ops/rnn.py:136'},
    'gru_scan_padded': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/gru.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/gru.py:50'},
    'gru_scan_bwd_padded': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/gru_bwd.cu',
        'replaces': 'pb_sed_tpu/ops/pallas/gru.py:357'},
    # the conv pair's entry kernels (Cin < 16: every tower's first layer):
    # the forward and the dw pass (with its reduce), counted by the pair's
    # wrappers where they run them; their times are device times
    # (torch.profiler) and the dw pass's those of a backward without dx.
    # That layer's dx (N = Cin) runs the wgmma kernel, under
    # conv2d_same_bwd
    'conv2d_same_entry': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/conv2d_entry.cuh',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:413'},
    'conv2d_same_bwd_entry': {
        'route': 'cuda', 'source': 'pb_sed_tpu_torch/csrc/conv2d_entry.cuh',
        'replaces': 'pb_sed_tpu/ops/pallas/conv.py:642'},
}
# the path each kernel's ``launches`` is read from: the deep training run
# drives the unfused kernels, the deep fuse_bn training run the fused
# conv pair; no path selects the fused GRU backward (as in the JAX
# package), so its count is that of its kernel phase
MAIN_PATH = dict({name: 'deep_training' for name in KERNELS},
                 bnrelu_conv2d_same='deep_fuse_bn_training',
                 bnrelu_conv2d_same_bwd='deep_fuse_bn_training',
                 gru_scan_bwd_fused='kernel_phase',
                 maxpool2d='towers_14a_training',
                 maxpool2d_bwd='towers_14a_training',
                 avgpool2d='towers_14b_training',
                 avgpool2d_bwd='towers_14b_training',
                 conv2d_same_padded='towers_14b_training',
                 conv2d_same_bwd_padded='towers_14b_training',
                 conv2d_same_f32='widths_15a_training',
                 conv2d_same_f32_bwd='widths_15a_training',
                 conv2d_same_f32_entry='widths_15a_training',
                 conv2d_same_f32_bwd_entry='widths_15a_training',
                 gru_scan_wide='widths_15b_training',
                 gru_scan_bwd_wide='widths_15b_training',
                 gru_scan_padded='widths_15c_training',
                 gru_scan_bwd_padded='widths_15c_training')
FORWARD = ('conv2d_same', 'maxpool_freq2', 'gru_scan', 'conv2d_same_entry')
SHALLOW = FORWARD + ('conv2d_same_bwd', 'maxpool_freq2_bwd', 'gru_scan_bwd',
                     'conv2d_same_bwd_entry')
DEEP = SHALLOW + ('avgpool_freq2', 'avgpool_freq2_bwd')
FUSED = ('bnrelu_conv2d_same', 'bnrelu_conv2d_same_bwd')
TRAIN_STEPS = 8
# the card's peak rates (NVIDIA H100 SXM data sheet, dense): HBM bytes/s,
# bf16 tensor-core, f32 and TF32 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12


def log(*args):
    print(*args, flush=True)


def collect_garbage():
    """Collect the cyclic garbage of earlier phases (up to ~140 000
    objects) before a host-clock measurement: a full collection of it
    takes 0.2-0.5 s on the card's host, and one that lands among 6 timed
    steps moves steps/s by a quarter."""
    gc.collect()


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


def graph_ms(fn, calls=10):
    """Median milliseconds a call of ``fn()`` takes replayed from a CUDA
    graph of ``calls`` calls: the device's time without the host's. A
    kernel of 0.03-0.15 ms (the pools) takes less than its wrapper's host
    time, so one call timed by events on an idle card mostly measures the
    host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, reps=5) / calls
    del graph
    return ms


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
    log_ptxas(path.with_suffix('.log').read_text())
    t0 = time.perf_counter()
    native.available()
    log(f'C++ wav reader build+load (g++, host code): '
        f'{time.perf_counter() - t0:.1f} s -> {native.library_path()}')
    return card


def log_ptxas(text):
    """Print ``-Xptxas -v``'s registers, static shared memory and spills
    per kernel (template arguments kept, the rest of the mangled name
    cut), once per kernel although two sources instantiate some, and
    ptxas's performance advisories (a serialized wgmma pipeline). The
    wgmma kernels' dynamic shared memory is in the per-layer lines, the
    GRU cluster kernels' in the per-shape lines; a spill in a GRU cluster
    kernel fails the run."""
    name = ''
    seen = set()
    for line in text.splitlines():
        if 'Compiling entry function' in line:
            mangled = line.split("'")[1]
            for kernel in ('conv2d_wgmma_kernel', 'conv2d_dw_wgmma_kernel',
                           'conv2d_dw_reduce_kernel', 'gru_scan_kernel',
                           'gru_scan_cluster_kernel', 'gru_bwd_kernel',
                           'gru_bwd_cluster_kernel', 'gru_part_reduce_kernel',
                           'maxpool_freq2', 'avgpool_freq2', 'maxpool2d',
                           'avgpool2d', 'gru_scan_wide_cluster_kernel',
                           'gru_bwd_wide_cluster_kernel',
                           'conv2d_f32_entry_kernel',
                           'conv2d_f32_dw_entry_kernel',
                           'conv2d_f32_dw_reduce_kernel',
                           'conv2d_f32_wgmma_kernel',
                           'conv2d_f32_dw_wgmma_kernel',
                           'conv2d_f32_split_kernel', 'conv2d_entry_kernel',
                           'conv2d_dw_entry_kernel',
                           'conv2d_dw_entry_reduce_kernel'):
                if kernel in mangled:
                    args = mangled.split(kernel, 1)[1]
                    # template arguments end in EE, a plain name in E
                    args = (args[:args.find('EE') + 1] if 'EE' in args
                            else args[:args.find('E')])
                    name = kernel + args.replace('ILi', '<').replace(
                        'ELi', ',').replace('ELb', ',').replace('E', '>')
                    break
            else:
                name = mangled[-40:]
        elif 'registers' in line or 'spill' in line:
            info = line.replace('ptxas info    :', '').strip()
            if (name, info) not in seen:
                seen.add((name, info))
                log(f'  ptxas {name}: {info}')
            if ('_cluster_kernel' in name and 'spill' in info
                    and '0 bytes spill stores, 0 bytes spill loads'
                    not in info):
                raise AssertionError(f'{name} spills: {info}')
        elif 'Potential Performance Loss' in line:
            log(f'  ptxas advisory: {line.split(":", 1)[1].strip()[:160]}')


def bound(nbytes, tensor_flops=0., vector_ops=0., tf32_flops=0.):
    """The least time (ms) the card could take for work that moves
    ``nbytes`` (each input read once, each output written once) and does
    ``tensor_flops`` bf16 tensor-core, ``vector_ops`` f32 and
    ``tf32_flops`` TF32 tensor-core operations, and which of the two
    binds: (ms, 'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (tensor_flops / BF16_FLOPS + vector_ops / F32_FLOPS
             + tf32_flops / TF32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def new_record():
    """A kernel's sums. A time no check measured stays None (printed as
    null), never 0."""
    return {'max_abs_err': 0., 'bound_ms': 0., 'bound_bytes_ms': 0.,
            'bound_operations_ms': 0., 'library_ms': None,
            **{f'{label}_{kind}': None
               for label in ('shallow', 'deep', 'towers', 'widths')
               for kind in ('ms', 'plain_ms', 'library_ms')}}


def _add(record, key, value):
    record[key] = (record.get(key) or 0.) + value


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


# per conv layer: times (kernel, cuDNN, bound) of each pass, the backward's
# device time by launch, and which design ran (printed as one JSON line)
CONV_ROWS = []
# per GRU shape: cuDNN's times beside the kernels' (one JSON line)
GRU_LIBRARY = []
# the max-pool forward's time of one call on an idle card, per pool
POOL_SINGLE_MS = []


def profile_kernels(fn):
    """Run ``fn()`` under ``torch.profiler``; returns (ms, key, count)
    of each device kernel by its self device time, largest first
    (operator rows, which repeat their kernels' time, left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        us = getattr(event, 'self_device_time_total', None)
        if us is None:
            us = getattr(event, 'self_cuda_time_total', 0.)
        if us > 0:
            rows.append((us / 1e3, event.key, event.count))
    return sorted(rows, reverse=True)


def bwd_split_ms(fn, reps=3):
    """Device ms per call of a conv backward's launches, by part: the dx
    (or da) GEMM, the dw partials, their reduce, and the wrapper's glue
    (casts, the weight flip); None when the profiler recorded no device
    kernel (it now and then records none)."""
    fn()
    torch.cuda.synchronize()
    rows = profile_kernels(lambda: [fn() for _ in range(reps)])
    if not rows:
        return None
    parts = {'dx': 0., 'dw': 0., 'reduce': 0., 'glue': 0.}
    for ms, key, _ in rows:
        part = ('reduce' if 'dw_reduce' in key or 'dw_entry_reduce' in key
                else 'dw' if 'conv2d_dw_' in key else
                'dx' if 'conv2d_wgmma_kernel' in key else 'glue')
        parts[part] += ms / reps
    return parts


def log_conv_layer(row, fwd_flops):
    """One line per conv layer: the design of each pass (wgmma or entry
    with the depth of its activation ring and its dynamic shared memory),
    and per pass the kernel's ms and TFLOP/s beside cuDNN's ms
    and the bound; the backward's split by launch."""
    def design(key):
        d = row['design'][key]
        return (f'{key}={d["design"]} (ring {d["stages"]} stages, '
                f'{d["smem"] / 1024:.0f} KiB)')

    def part(key, flops):
        if key not in row:
            return ''
        ms, lib, bnd = row[key]
        lib_s = '' if lib is None else f', cuDNN {lib:.3f}'
        return (f' | {key} {ms:.3f} ms {flops / ms / 1e9:.0f} TFLOP/s '
                f'(bound {bnd:.3f}{lib_s})')

    split = ''
    for key in ('bwd_split', 'fused_bwd_split'):
        if key in row:
            split += f' | {key}: ' + ('not recorded' if row[key] is None
                                      else ', '.join(f'{k} {v:.3f}' for k, v
                                                     in row[key].items()))
    log(f'conv layer {row["tower"]} {row["layer"]} ({row["F"]}, '
        f'{row["Cin"]} -> {row["Cout"]}): design '
        + ' '.join(design(key) for key in ('fwd', 'dx', 'dw'))
        + part('fwd', fwd_flops)
        + part('bwd', 2 * fwd_flops) + part('fused_fwd', fwd_flops)
        + part('fused_bwd', 2 * fwd_flops) + split)


def device_ms(fn, keys=None, reps=5):
    """Device ms per call of ``fn()`` (torch.profiler): of the kernels
    whose names hold one of ``keys``, of every kernel with None. The
    profiler now and then records no device kernel: after three such
    tries it raises."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        rows = profile_kernels(lambda: [fn() for _ in range(reps)])
        if rows:
            return sum(ms for ms, key, _ in rows
                       if keys is None or any(k in key for k in keys)) / reps
    raise AssertionError('the profiler recorded no device kernel in three '
                         'tries')


def dw_work(p, cin, cout, taps=9):
    """Bytes and operations of the dw pass alone (a backward without dx):
    x and gy read once, the f32 dw written once."""
    return bound(2 * p * cin + 2 * p * cout + 4 * taps * cin * cout,
                 2. * p * taps * cin * cout)


# the entry layer's kernels by the profiler's names: the forward, the dx
# GEMM (N = Cin on the wgmma kernel) and the dw pass with its reduce
ENTRY_KERNELS = {'fwd': ('conv2d_entry_kernel',),
                 'dx': ('conv2d_wgmma_kernel',),
                 'dw': ('conv2d_dw_entry_kernel',
                        'conv2d_dw_entry_reduce_kernel')}


def dx_work(p, cin, cout, taps=9):
    """Bytes and operations of the dx GEMM alone: gy read once, dx
    written once, the weights read once."""
    return bound(2 * p * cout + 2 * p * cin + 2 * taps * cin * cout,
                 2. * p * taps * cin * cout)


def entry_dx(label, shape, x, w, gy):
    """The dx GEMM of a layer with Cin < 16 (N = Cin on the wgmma
    kernel): its device time inside the backward (torch.profiler, the
    dx kernel alone), cuDNN's dgrad (``convolution_backward`` for the
    input alone, channels-last bf16) and the bound; returns [ms, cuDNN
    ms, bound ms] and logs them with the share of the bound."""
    p = x.shape[0] * x.shape[1] * x.shape[2]
    cin, cout = w.shape[2], w.shape[3]
    xn, wn, gyn = _nchw(x), _oihw(w), _nchw(gy)
    ms = device_ms(lambda: conv2d_same_bwd(x, w, gy), ENTRY_KERNELS['dx'])
    lib = device_ms(lambda: torch.ops.aten.convolution_backward(
        gyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [True, False, False]))
    work = dx_work(p, cin, cout)
    log(f'entry dx {label} {shape[0]} ({cout} -> {cin}): {ms:.4f} ms device '
        f'(wgmma, N = {cin}), bound {work[0]:.4f} ({work[1]}), share '
        f'{work[0] / ms:.2f}, cuDNN dgrad {lib:.4f} ms')
    return [ms, lib, work[0]]


def check_entry_layer(row, records, label, shape, x, w, b, gy):
    """The entry pair at a layer with Cin < 16 (csrc/conv2d_entry.cuh):
    the forward, and the dw of a backward without dx (what a layer whose
    input needs no gradient runs), each against its plain version (2^-7
    and 1e-3 * max|ref|; the dw equal in every bit to the dw of the
    backward with dx), with its device time (torch.profiler: the entry
    kernels alone, the dw pass with its reduce), its bound, its share of
    the bound and cuDNN's device time for the same function (``F.conv2d``;
    ``convolution_backward`` for the weight alone), on the channels-last
    tensors. Added to ``records['conv2d_same_entry']`` and
    ``records['conv2d_same_bwd_entry']`` and to the layer's row."""
    p = x.shape[0] * x.shape[1] * x.shape[2]
    cin, cout = w.shape[2], w.shape[3]
    xn, wn, bn, gyn = _nchw(x), _oihw(w), b.to(torch.bfloat16), _nchw(gy)
    got, ref = conv2d_same(x, w, b), conv2d_same_plain(x, w, b)
    fwd_ms = device_ms(lambda: conv2d_same(x, w, b), ENTRY_KERNELS['fwd'])
    fwd_lib = device_ms(lambda: F.conv2d(xn, wn, bn, padding=1))
    fwd_work = conv_work(p, cin, cout)
    _check('conv2d_same_entry', shape, got, ref,
           2. ** -7 * float(ref.float().abs().max()), fwd_ms,
           device_ms(lambda: conv2d_same_plain(x, w, b), reps=2),
           records['conv2d_same_entry'], label, fwd_lib, fwd_work)
    del got, ref
    no_dx, dw = conv2d_same_bwd(x, w, gy, need_dx=False)
    ref_dw = conv2d_same_bwd_plain(x, w, gy, need_dx=False)[1]
    if no_dx is not None or not torch.equal(dw, conv2d_same_bwd(x, w,
                                                                gy)[1]):
        raise AssertionError(f'conv2d_same_bwd {shape}: the dw without dx '
                             f'differs from the dw with dx')
    dw_ms = device_ms(lambda: conv2d_same_bwd(x, w, gy, need_dx=False),
                      ENTRY_KERNELS['dw'])
    dw_lib = device_ms(lambda: torch.ops.aten.convolution_backward(
        gyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [False, True, False]))
    work = dw_work(p, cin, cout)
    _check('conv2d_same_bwd_entry dw (no dx)', shape, dw, ref_dw,
           1e-3 * float(ref_dw.abs().max()), dw_ms,
           device_ms(lambda: conv2d_same_bwd_plain(x, w, gy, need_dx=False),
                     reps=2),
           records['conv2d_same_bwd_entry'], label, dw_lib, work)
    row['entry'] = {'fwd': [fwd_ms, fwd_lib, fwd_work[0]],
                    'dx': entry_dx(label, shape, x, w, gy),
                    'dw': [dw_ms, dw_lib, work[0]]}
    log(f'entry conv {label} {shape[0]} ({cin} -> {cout}): forward '
        f'{fwd_ms:.4f} ms device, bound {fwd_work[0]:.4f} ({fwd_work[1]}), '
        f'share {fwd_work[0] / fwd_ms:.2f}, cuDNN {fwd_lib:.4f} ms; dw '
        f'without dx {dw_ms:.4f} ms, bound {work[0]:.4f} ({work[1]}), '
        f'share {work[0] / dw_ms:.2f}, cuDNN {dw_lib:.4f} ms')


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
        row = {'tower': label, 'layer': layer, 'F': f, 'Cin': cin,
               'Cout': cout, 'design': conv_designs(f, cin, cout)}
        # from Cin = 16 up every pass runs the wgmma kernels, each ring
        # >= 3 stages, or 2 where that leaves room for two blocks an SM
        # (half of 227 KB: the narrow tiles); the entry layer (Cin < 16)
        # its forward (a ring of 2) and dw (3) on the entry kernels, its
        # dx (N = Cin) on the wgmma one
        want = ({'fwd': 'wgmma', 'dx': 'wgmma', 'dw': 'wgmma'} if cin >= 16
                else {'fwd': 'entry', 'dx': 'wgmma', 'dw': 'entry'})
        least = {'wgmma': 3, 'entry': 2}

        def ring_ok(d):
            return d['stages'] >= least[d['design']] or (
                d['design'] == 'wgmma' and d['stages'] == 2
                and d['smem'] <= 232448 // 2)
        if any(d['design'] != want[key] or not ring_ok(d)
               for key, d in row['design'].items()):
            raise AssertionError(f'conv layer {shape}: designs '
                                 f'{row["design"]}, expected {want}')
        row['fwd'] =[cuda_ms(lambda: conv2d_same(x, w, b), reps=5),
                      cuda_ms(lambda: F.conv2d(xn, wn, bn, padding=1),
                              reps=5), conv_work(p, cin, cout)[0]]
        _check('conv2d_same', shape, got, ref,
               2. ** -7 * float(ref.float().abs().max()), row['fwd'][0],
               cuda_ms(lambda: conv2d_same_plain(x, w, b), reps=5),
               records['conv2d_same'], label, row['fwd'][1],
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
        row['bwd'] = [k_ms, lib_ms, conv_work(p, cin, cout,
                                              backward=True)[0]]
        row['bwd_split'] = bwd_split_ms(lambda: conv2d_same_bwd(x, w, gy))
        if layer in fused:
            # scale in [.5, 1.5), shift ~ N(0, .5^2): about half the
            # pre-activations negative, the shift often positive
            scale = .5 + torch.rand(cin, generator=gen, device=dev)
            shift = randn(cin, scale=.5)
            args = (x, scale, shift, w)
            got = bnrelu_conv2d_same(*args, b)
            ref = bnrelu_conv2d_same_plain(*args, b)
            torch.cuda.synchronize()
            row['fused_fwd'] = [
                cuda_ms(lambda: bnrelu_conv2d_same(*args, b), reps=5), None,
                conv_work(p, cin, cout, affine=True)[0]]
            _check('bnrelu_conv2d_same', shape, got, ref,
                   2. ** -7 * float(ref.float().abs().max()),
                   row['fused_fwd'][0],
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
            row['fused_bwd'] = [k_ms, None, conv_work(
                p, cin, cout, affine=True, backward=True)[0]]
            row['fused_bwd_split'] = bwd_split_ms(
                lambda: bnrelu_conv2d_same_bwd(*args, gy))
        if cin < 16:
            check_entry_layer(row, records, label, shape, x, w, b, gy)
        log_conv_layer(row, 2. * p * 9 * cin * cout)
        CONV_ROWS.append(row)
        del x, gy
        torch.cuda.empty_cache()
    # max-pool: a compare and a copy (forward), a compare and a select
    # (backward), bit-exact, on tie-heavy input (every padded frame ties);
    # the library calls: max_pool2d and its backward with the indices. All
    # pool times by CUDA-graph replay (graph_ms); one call of the forward
    # timed by events on an idle card is logged beside it
    for f, c in pools:
        x = randn(BATCH, FRAMES, f, c).to(torch.bfloat16)
        x[:, FRAMES - 100:] = 0.
        gy = randn(BATCH, FRAMES, f // 2, c).to(torch.bfloat16)
        n = BATCH * FRAMES * f * c
        xn, gyn = _nchw(x), _nchw(gy)
        got = maxpool_freq2(x)
        ref = maxpool_freq2_plain(x)
        torch.cuda.synchronize()
        single = cuda_ms(lambda: maxpool_freq2(x))
        POOL_SINGLE_MS.append(single)
        log(f'maxpool_freq2 {(BATCH, FRAMES, f, c)}: one call on an idle '
            f'card {single:.4f} ms')
        _check('maxpool_freq2', (BATCH, FRAMES, f, c), got, ref, 0.,
               graph_ms(lambda: maxpool_freq2(x)),
               graph_ms(lambda: maxpool_freq2_plain(x)),
               records['maxpool_freq2'], label,
               graph_ms(lambda: F.max_pool2d(xn, (1, 2))),
               bound(2 * n + n, 0., n / 2))
        got = maxpool_freq2_bwd(x, gy)
        ref = maxpool_freq2_bwd_plain(x, gy)
        torch.cuda.synchronize()
        _, idx = F.max_pool2d(xn, (1, 2), return_indices=True)
        _check('maxpool_freq2_bwd', (BATCH, FRAMES, f, c), got, ref, 0.,
               graph_ms(lambda: maxpool_freq2_bwd(x, gy)),
               graph_ms(lambda: maxpool_freq2_bwd_plain(x, gy)),
               records['maxpool_freq2_bwd'], label,
               graph_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                   gyn, xn, [1, 2], [1, 2], [0, 0], [1, 1], False, idx)),
               bound(2 * n + n + 2 * n, 0., n / 2))
        del idx
    # the residual average pool (F, C -> F / 2, 2C): an add and an exact
    # halving, bit-exact; the library calls: avg_pool2d and its backward
    # (without the channel pad). The backward reads the cotangent of the
    # C channels that are not pad (f32, half the rows: 2n bytes) and
    # writes dx (bf16: 2n bytes)
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
               graph_ms(lambda: avgpool_freq2(x, 2 * c)),
               graph_ms(lambda: avgpool_freq2_plain(x, 2 * c)),
               records['avgpool_freq2'], label,
               graph_ms(lambda: F.avg_pool2d(xn, (1, 2))),
               bound(2 * n + 4 * n, 0., n))
        got = avgpool_freq2_bwd(gy, c, x.dtype)
        ref = avgpool_freq2_bwd_plain(gy, c, x.dtype)
        torch.cuda.synchronize()
        _check('avgpool_freq2_bwd', shape, got, ref, 0.,
               graph_ms(lambda: avgpool_freq2_bwd(gy, c, x.dtype)),
               graph_ms(lambda: avgpool_freq2_bwd_plain(gy, c, x.dtype)),
               records['avgpool_freq2_bwd'], label,
               graph_ms(lambda: torch.ops.aten.avg_pool2d_backward(
                   gyn, xn, [1, 2], [1, 2], [0, 0], False, True, None)),
               bound(2 * n + 2 * n, 0., n))
    # GRU: same bf16 rounding points on both sides; the recurrence carries
    # accumulation-order differences through T steps. Bound: the
    # kernel-vs-scan drift measured for the TPU kernel, 5.3e-3 (forward),
    # 5.3e-3 * max|ref| (backward). Forward at every serving shape,
    # backward at the training step's (B clips), the fused backward there
    # too, against its own plain version and against the split kernel's
    # dw_hh/db_hh (the two differ in where dgates_n rounds); its dxw and
    # dh0 come from the same chain as the split kernel's, bit for bit. The
    # library call: cuDNN's bf16 GRU with identity input weights
    # (cudnn_gru), which computes the same recurrence plus one identity
    # product.
    for d, b, t, h in grus:
        xw = randn(d, b, t, 3 * h).to(torch.bfloat16)
        w_hh = randn(d, h, 3 * h, scale=h ** -.5)
        b_hh = randn(d, 3 * h, scale=.1)
        h0 = torch.zeros(d, b, h, device=dev)
        designs = gru_designs(d, b, t, h)
        for key, v in designs.items():
            log(f'gru design {(d, b, t, h)} {key}: {v["design"]}, cluster of '
                f'{v["cluster"]}, {v["rows"]} rows a '
                f'{"cluster" if v["cluster"] > 1 else "block"}, '
                f'{v["smem"] / 1024:.0f} KiB shared memory a block, '
                f'{v["coresident"]} clusters co-resident')
            # B clips x T frames is the training and tagging shape: w_hh
            # must be resident in a cluster's shared memory there
            if b == BATCH and v['design'] != 'cluster':
                raise AssertionError(f'GRU {key} at {(d, b, t, h)} runs the '
                                     f'{v["design"]} kernel')
        y = gru_scan(xw, w_hh, b_hh, h0)
        ref = gru_scan_plain(xw, w_hh, b_hh, h0)
        torch.cuda.synchronize()
        k_ms = cuda_ms(lambda: gru_scan(xw, w_hh, b_hh, h0), reps=5)
        g = randn(d, b, t, h, scale=1e-2) if b == BATCH else None
        lib = cudnn_gru(xw, w_hh, b_hh, h0, ref, g)
        lib.update(shape=(d, b, t, h), fwd_kernel_ms=k_ms)
        _check('gru_scan', (d, b, t, h), y, ref, 5.3e-3, k_ms,
               cuda_ms(lambda: gru_scan_plain(xw, w_hh, b_hh, h0), reps=3,
                       warmup=1),
               records['gru_scan'], label, lib['fwd'], gru_work(d, b, t, h))
        _log_gru_step('fwd', (d, b, t, h), k_ms,
                      lambda: gru_scan(xw, w_hh, b_hh, h0))
        log(f'cudnn gru {(d, b, t, h)} forward: {lib["fwd"]:.3f} ms, '
            f'{lib["fwd"] - lib["ident"]:.3f} without the identity product '
            f'({lib["ident"]:.3f} ms); gru_scan / cuDNN '
            f'{k_ms / lib["fwd"]:.3f}; max|d| against gru_scan_plain '
            f'{lib["err"]:.3e} (cuDNN carries the state in bf16); its '
            f'kernels: {lib["kernels"]}')
        del ref
        if b == BATCH:
            args = (xw, w_hh, b_hh, h0, y, g)
            for split, name in ((True, 'gru_scan_bwd'),
                                (False, 'gru_scan_bwd_fused')):
                grads = gru_scan_bwd(*args, split=split)
                refs = gru_scan_bwd_plain(*args, split=split)
                torch.cuda.synchronize()
                k_ms = cuda_ms(lambda: gru_scan_bwd(*args, split=split),
                               reps=5)
                lib[f'{name}_ms'] = k_ms
                p_ms = cuda_ms(lambda: gru_scan_bwd_plain(*args, split),
                               reps=3, warmup=1)
                for i, part in enumerate(('dxw', 'dw_hh', 'db_hh', 'dh0')):
                    _check(f'{name} {part}', (d, b, t, h), grads[i], refs[i],
                           5.3e-3 * float(refs[i].float().abs().max()),
                           k_ms if i == 0 else 0., p_ms if i == 0 else 0.,
                           records[name], label,
                           lib['bwd'] if i == 0 else None,
                           gru_work(d, b, t, h, True) if i == 0 else None)
                _log_gru_step('bwd' if split else 'bwd_fused', (d, b, t, h),
                              k_ms, lambda: gru_scan_bwd(*args, split=split))
                if split:
                    split_grads = grads
                else:
                    # the fused kernel against the split one: dxw and dh0
                    # from the same chain, in every bit; dw_hh and db_hh
                    # within the backward's bound
                    for i, part in enumerate(('dxw', 'dw_hh', 'db_hh',
                                              'dh0')):
                        a, r = grads[i], split_grads[i]
                        tol = 0. if part in ('dxw', 'dh0') else \
                            5.3e-3 * float(r.float().abs().max())
                        err = float((a.float() - r.float()).abs().max())
                        log(f'{name} vs split kernel {part} {(d, b, t, h)}:'
                            f' max|d|={err:.3e} tol={tol:.3e}')
                        if err > tol:
                            raise AssertionError(
                                f'{name} {part}: fused and split kernels '
                                f'differ by {err} > {tol}')
                # the split kernel adds its partials of dh in rank order,
                # the fused one its dw_hh slices in tile order: a second
                # run agrees in every bit
                again = gru_scan_bwd(*args, split=split)
                if not all(torch.equal(a, r) for a, r in zip(grads, again)):
                    raise AssertionError(f'{name} {(d, b, t, h)}: two runs '
                                         f'differ')
                log(f'{name} {(d, b, t, h)}: two runs agree in every bit')
                del again
                del grads, refs
            log(f'cudnn gru {(d, b, t, h)} backward: {lib["bwd"]:.3f} ms, '
                f'{lib["bwd"] - 2 * lib["ident"]:.3f} without the two '
                f'identity products (dx through weight_ih, and its '
                f'gradient); split wrapper / cuDNN '
                f'{lib["gru_scan_bwd_ms"] / lib["bwd"]:.3f}, fused wrapper / '
                f'cuDNN {lib["gru_scan_bwd_fused_ms"] / lib["bwd"]:.3f}')
            del split_grads, args
        GRU_LIBRARY.append(lib)
        del xw, y, g
        torch.cuda.empty_cache()


def check_chain_gru_shapes(records):
    """The GRU forward at ``CHAIN_GRU_SHAPES`` against its plain version,
    with the design that ran: 32 rows of 250 steps must take the cluster
    design (``gru_cluster_takes``), 8 000 rows of 11 steps take the
    row-tiled one. The error joins the kernel's ``max_abs_err``; its times
    are printed and stay out of the kernels line's sums, which keep the
    shapes of the earlier runs."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(5)
    for d, b, t, h in CHAIN_GRU_SHAPES:
        xw = torch.randn(d, b, t, 3 * h, generator=gen, device=dev).to(
            torch.bfloat16)
        w_hh = torch.randn(d, h, 3 * h, generator=gen, device=dev) * h ** -.5
        b_hh = torch.randn(d, 3 * h, generator=gen, device=dev) * .1
        h0 = torch.zeros(d, b, h, device=dev)
        design = gru_designs(d, b, t, h)['fwd']
        log(f'gru design {(d, b, t, h)} fwd (tuning chain): '
            f'{design["design"]}, cluster of {design["cluster"]}, '
            f'{design["rows"]} rows, {design["smem"] / 1024:.0f} KiB shared '
            f'memory a block')
        want = 'cluster' if b == BATCH else 'row_tiled'
        if design['design'] != want:
            raise AssertionError(f'GRU at {(d, b, t, h)} runs the '
                                 f'{design["design"]} kernel, not {want}')
        y = gru_scan(xw, w_hh, b_hh, h0)
        ref = gru_scan_plain(xw, w_hh, b_hh, h0)
        torch.cuda.synchronize()
        scratch = new_record()
        _check('gru_scan', (d, b, t, h), y, ref, 5.3e-3,
               cuda_ms(lambda: gru_scan(xw, w_hh, b_hh, h0), reps=5),
               cuda_ms(lambda: gru_scan_plain(xw, w_hh, b_hh, h0), reps=3,
                       warmup=1), scratch, 'shallow',
               work=gru_work(d, b, t, h))
        records['gru_scan']['max_abs_err'] = max(
            records['gru_scan']['max_abs_err'], scratch['max_abs_err'])
        del xw, y, ref
    torch.cuda.empty_cache()


def check_strong_shapes(records):
    """The kernels at the shapes only the strong-label BiCRNN gives them
    (``STRONG_CONV_LAYERS``, ``STRONG_GRU_SHAPES``), with
    :func:`check_kernels`' checks, designs, times, cuDNN's and the bounds:
    the entry conv at 11 input channels (the entry kernels forward and
    dw, with the dw without dx, the wgmma one for dx) forward, dx and
    dw, and the GRU forward over 16 clips. The errors join the kernels'
    ``max_abs_err``; the times are printed (the conv layer also as JSON)
    and stay out of the kernels line's sums, which keep the shapes of the
    earlier runs."""
    scratch = {name: new_record() for name in KERNELS}
    rows = len(CONV_ROWS)
    check_kernels(scratch, 'shallow', 9, STRONG_CONV_LAYERS, (),
                  STRONG_GRU_SHAPES)
    strong_rows = CONV_ROWS[rows:]
    del CONV_ROWS[rows:]
    log('strong conv layers: ' + json.dumps(strong_rows))
    for name, rec in scratch.items():
        records[name]['max_abs_err'] = max(records[name]['max_abs_err'],
                                           rec['max_abs_err'])


def cudnn_gru(xw, w_hh, b_hh, h0, ref, g=None):
    """cuDNN's time for the GRU rows (timing only; the port never calls
    it): per direction one bf16 ``torch.nn.GRU`` with weight_ih = I(3H),
    bias_ih = 0, weight_hh = w_hh[d]^T and bias_hh = b_hh[d] computes
    gru_scan's recurrence (PyTorch's gate order (r, z, n), b_hh inside
    r * (h W_hn + b_hn)) plus one identity product. Returns the forward's
    ms in eval mode (both directions), ``ident`` (the identity product
    alone: a bf16 (B*T, 3H) x (3H, 3H) matmul a direction), ``err`` (max|d|
    of its output against ``ref``, gru_scan_plain's), the three largest
    device kernels of a forward, and with a cotangent ``g`` ``bwd``: the
    time of forward and backward (dxw, dh0, dw_hh, db_hh) less that of the
    training-mode forward."""
    d, b, t, g3 = xw.shape
    h = g3 // 3
    dev = xw.device
    bf16 = torch.bfloat16
    grus = []
    for i in range(d):
        gru = torch.nn.GRU(g3, h, batch_first=True).to(dev, bf16)
        with torch.no_grad():
            gru.weight_ih_l0.copy_(torch.eye(g3))
            gru.bias_ih_l0.zero_()
            gru.weight_hh_l0.copy_(w_hh[i].t())
            gru.bias_hh_l0.copy_(b_hh[i])
        gru.weight_ih_l0.requires_grad_(False)
        gru.bias_ih_l0.requires_grad_(False)
        grus.append(gru.eval())
    xs = [xw[i].to(bf16) for i in range(d)]
    hs = [h0[i][None].to(bf16) for i in range(d)]

    def forward():
        return [gru(x, h_) for gru, x, h_ in zip(grus, xs, hs)]

    eye = torch.eye(g3, device=dev, dtype=bf16)
    with torch.no_grad():
        out = torch.stack([o[0] for o in forward()]).float()
        res = {'fwd': cuda_ms(forward, reps=5),
               'ident': cuda_ms(lambda: [x.reshape(-1, g3) @ eye for x in xs],
                                reps=5),
               'err': float((out - ref).abs().max()),
               'kernels': [key[:48] for _, key, _ in
                           profile_kernels(forward)[:3]]}
    del out
    if g is not None:
        for gru in grus:
            gru.train()
        xs = [x.detach().requires_grad_() for x in xs]
        hs = [h_.detach().requires_grad_() for h_ in hs]
        gys = [g[i].to(bf16) for i in range(d)]
        wrt = xs + hs + [p for gru in grus
                         for p in (gru.weight_hh_l0, gru.bias_hh_l0)]

        def train_forward():
            return [o for o, _ in forward()]

        def forward_backward():
            torch.autograd.grad(train_forward(), wrt, gys)

        res['bwd'] = (cuda_ms(forward_backward, reps=5)
                      - cuda_ms(train_forward, reps=5))
    return res


def log_redesigned(records):
    """The sums the max-pool forward and the fused GRU backward are held
    to: the pool's share of its bound over the 8 pools (CUDA-graph replay,
    and one call on an idle card), the fused wrapper against the split one at
    the two training shapes; and cuDNN's GRU times per shape (JSON)."""
    pool = records['maxpool_freq2']
    ms = _total(pool['shallow_ms'], pool['deep_ms'])
    single = sum(POOL_SINGLE_MS)
    log(f'maxpool_freq2 over the {len(POOL_SINGLE_MS)} pools: kernel '
        f'{ms:.3f} ms (CUDA-graph replay), bound '
        f'{pool["bound_ms"]:.3f} ms, share {pool["bound_ms"] / ms:.3f}; one '
        f'call on an idle card {single:.3f} ms, share '
        f'{pool["bound_ms"] / single:.3f}')
    fused, split = (_total(records[name]['shallow_ms'],
                           records[name]['deep_ms'])
                    for name in ('gru_scan_bwd_fused', 'gru_scan_bwd'))
    log(f'GRU backward wrappers at (2, 32, 500, 256) and (2, 32, 500, 512): '
        f'fused {fused:.3f} ms, split {split:.3f} ms, fused / split '
        f'{fused / split:.3f}')
    log('gru library: ' + json.dumps(GRU_LIBRARY))
    for name, what in (('conv2d_same_entry', 'forward'),
                       ('conv2d_same_bwd_entry', 'dw without dx')):
        rec = records[name]
        ms = _total(rec['shallow_ms'], rec['deep_ms'])
        log(f'entry conv {what} at shallow and deep L0: {ms:.4f} ms device, '
            f'bound {rec["bound_ms"]:.4f} ms, share '
            f'{rec["bound_ms"] / ms:.2f}, cuDNN '
            f'{_total(rec["shallow_library_ms"], rec["deep_library_ms"]):.4f}'
            f' ms')


def _log_gru_step(key, shape, k_ms, fn):
    """A GRU wrapper's ms (``k_ms``, of ``fn()``) and its kernel's alone
    (``torch.profiler``: the wrapper adds casts and, backward, the
    weight-gradient contraction), the kernel's time per serial step, and
    the row-tiled kernel's ms of before the cluster design where that was
    recorded."""
    t, h = shape[2], shape[3]
    kernel = sum(ms for ms, name, _ in profile_kernels(fn)
                 if any(part in name for part in ('gru_scan', 'gru_bwd')))
    earlier = EARLIER_GRU_MS.get((key, h)) if shape[1] == BATCH else None
    was = ('' if earlier is None else
           f'; the row-tiled kernel took {earlier:.3f} ms '
           f'({1e3 * earlier / t:.1f} us a step)')
    alone = ('kernel alone not recorded' if not kernel else
             f'kernel alone {kernel:.3f} ms, {1e3 * kernel / t:.2f} us a '
             f'serial step')
    log(f'gru {key} {shape}: wrapper {k_ms:.3f} ms; {alone}{was}')


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


def _model_class(strong=False):
    from pb_sed_tpu_torch.models import strong_label, weak_label
    return strong_label.CRNN if strong else weak_label.CRNN


def _random_flat(config, strong=False, seed=0):
    """Seeded random weights for ``config``'s CRNN (the weak FBCRNN, or
    with ``strong`` the BiCRNN) in the JAX flat layout, passed once
    through the bridge (``bridge.random_flat``, ``load_flat``,
    ``export_flat``)."""
    from pb_sed_tpu_torch import bridge
    cls = _model_class(strong)
    template = cls.from_config(cls.get_config(config), device='cpu')
    template.load_state_dict(bridge.random_flat(template.state_dict(),
                                                seed=seed))
    return template.state_dict()


def _model(config, flat, device='cpu', strong=False):
    cls = _model_class(strong)
    model = cls.from_config(cls.get_config(config), device='cpu')
    model.load_state_dict(flat)           # bridge.load_flat
    return model.to(device)


def _config(net, k, fuse_bn=False, augment=True, strong=1., **more):
    """``fbcrnn_config(net)`` at full width with ``k`` classes (and
    ``more`` of its arguments), the 2-D tower's ``fuse_bn`` set as asked
    (the weights do not depend on it)."""
    from pb_sed_tpu_torch.models.net_configs import fbcrnn_config
    config = fbcrnn_config(net, num_events=k, augment=augment,
                           strong_fwd_bwd_loss_weight=strong, **more)
    config['cnn']['cnn_2d']['fuse_bn'] = fuse_bn
    return config


def _serve(model, methods, batches, k, label, kernels=FORWARD, low=1e-5,
           stats=None, frames=None):
    """Run ``methods`` (name, function, kwargs) on ``batches`` with the
    launch counters set to 0 first; check that ``kernels`` launched and
    the shapes, finiteness and score range ([low, 1 - low]: the FBCRNN's
    bounded sigmoid, or [0, 1] for the BiCRNN's plain one); return
    (scores by method, launches). ``stats``, a dict, receives the clips/s
    of each method and the peak memory (GiB). ``frames(name, seq_len)``
    gives each clip's expected frames (default :func:`_expected_frames`:
    a tower without time pools)."""
    frames = frames or _expected_frames
    for name, fn, kwargs in methods:      # warm-up: cuFFT/cuBLAS plans
        fn(model, batches[:1], **kwargs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    collect_garbage()
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
        if stats is not None:
            stats[f'{name}_clips_per_s'] = clips / dt
    if stats is not None:
        stats['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
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
                want = (frames(name, int(sl)), k)
                if y.shape != want:
                    raise AssertionError(f'{name} {clip}: shape {y.shape} '
                                         f'!= {want}')
                if not np.isfinite(y).all():
                    raise AssertionError(f'{name} {clip}: non-finite')
                if y.min() < low or y.max() > 1 - low:
                    raise AssertionError(
                        f'{name} {clip}: scores outside [{low}, 1 - {low}]: '
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


def phase_slice(stats=None):
    """The full-width shallow FBCRNN served on the card through the
    inference engine; returns the kernels' launch counts of that run
    (``stats``, a dict, receives its clips/s and peak memory)."""
    from pb_sed_tpu_torch.models import base
    config = _config('shallow', 10)
    flat = _random_flat(config)
    model = _model(config, flat, 'cuda')
    log(f'FBCRNN shallow: {model.num_parameters()} parameters, '
        f'{len(flat)} flat tensors')
    batches = _synthetic_batches(model.module.feature_extractor.stft)
    methods = _methods(base)
    results, launches = _serve(model, methods, batches, 10, 'shallow',
                               stats=stats)
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


def _train_batches(stft, n, batch_size, seconds, seed, k=10, strong=False):
    """``n`` training batches of ``batch_size`` clips of ``seconds`` s at
    16 kHz: noise with zeroed tails (unequal lengths, the first clip
    full), weak targets with some soft (.5) entries, boundary targets
    for the weakly positive classes, and every third clip without frame
    labels (.5: not fully labeled). With ``strong`` (the BiCRNN's
    batches): the weak targets as ``tag_condition``, as the strong
    recipe maps them, and ``strong_targets``: the boundary targets, with
    every third clip's frames soft (.5) over a span of one class only, as
    a pseudo-labeled clip's undetected tag leaves them."""
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
        if strong:
            for j in range(0, batch_size, 3):
                on, off = np.sort(rng.randint(0, seq_len[j], 2))
                boundary[j, rng.randint(k), on:off + 1] = .5
            out.append({'audio_data': audio, 'seq_len': seq_len,
                        'strong_targets': boundary, 'tag_condition': weak})
            continue
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
    first conv feeds their norm (both FBCRNN heads, the BiCRNN's one)."""
    fed = {f'{head}.output_net.conv_0.bias'
           for head in ('rnn_fwd', 'rnn_bwd', 'rnn')}
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


@contextlib.contextmanager
def _convs_summed_in_f64():
    """The CPU's plain convs (forward, dx and dw; the fused conv's and the
    member axis' through them) summed in f64 and rounded once: the same
    function with its sums in another order, as the card's kernels sum in
    theirs."""
    from pb_sed_tpu_torch.ops.kernels import conv as kc
    plain = (kc.conv2d_same_plain, kc.conv2d_same_bwd_plain)

    def forward(x, w, b):
        y = kc._conv_same(x.double().permute(0, 3, 1, 2),
                          w.to(torch.bfloat16).double().permute(3, 2, 0, 1))
        if b is not None:
            y = y + b.double()[None, :, None, None]
        return y.permute(0, 2, 3, 1).float().to(torch.bfloat16).contiguous()

    def backward(x, w, gy, need_dx=True):
        kt, kf, cin, cout = w.shape
        gf = gy.to(torch.bfloat16).double().permute(0, 3, 1, 2)
        dx = None
        if need_dx:
            w_flip = w.to(torch.bfloat16).double().flip(0, 1)
            dx = kc._conv_same(gf, w_flip.permute(2, 3, 0, 1), flip=True)
            dx = dx.permute(0, 2, 3, 1).float().to(torch.bfloat16).contiguous()
        xf = x.double().permute(0, 3, 1, 2)
        if kt % 2 and kf % 2:
            dw = torch.nn.grad.conv2d_weight(
                xf, (cout, cin, kt, kf), gf,
                padding=((kt - 1) // 2, (kf - 1) // 2))
        else:
            dw = torch.nn.grad.conv2d_weight(
                F.pad(xf, kc._same_pads(kt, kf)), (cout, cin, kt, kf), gf)
        return dx, dw.permute(2, 3, 1, 0).float().contiguous()

    kc.conv2d_same_plain, kc.conv2d_same_bwd_plain = forward, backward
    try:
        yield
    finally:
        kc.conv2d_same_plain, kc.conv2d_same_bwd_plain = plain


@contextlib.contextmanager
def _gru_summed_in_f64():
    """The CPU's plain GRU (forward and backward; a stacked lane's through
    them) with its products summed in f64 and rounded once to f32, its
    bf16 rounding points kept: the same function with its sums in another
    order, as the card's kernels sum in theirs."""
    from pb_sed_tpu_torch.ops.kernels import gru as kg
    plain = (kg.gru_scan_plain, kg.gru_scan_bwd_plain)

    def bmm(a, b):
        return torch.bmm(a.double(), b.double()).float()

    def forward(xw, w_hh, b_hh, h0):
        xw = xw.to(torch.bfloat16).float()
        w = w_hh.to(torch.bfloat16).float()
        bias = b_hh.float()[:, None, :]
        h, hdim = h0.float(), h0.shape[-1]
        ys = []
        for t in range(xw.shape[2]):
            hw = bmm(h.to(torch.bfloat16).float(), w) + bias
            x_t = xw[:, :, t]
            r = torch.sigmoid(x_t[..., :hdim] + hw[..., :hdim])
            z = torch.sigmoid(x_t[..., hdim:2 * hdim]
                              + hw[..., hdim:2 * hdim])
            n = torch.tanh(x_t[..., 2 * hdim:] + r * hw[..., 2 * hdim:])
            h = (1. - z) * n + z * h
            ys.append(h)
        return torch.stack(ys, dim=2)

    def backward(xw, w_hh, b_hh, h0, y, g, split=True):
        xw = xw.to(torch.bfloat16).float()
        w = w_hh.to(torch.bfloat16).float()
        bias = b_hh.float()[:, None, :]
        h_prev = kg._h_prev(h0, y)
        hp, g = h_prev.float(), g.float()
        d, b, t, three_h = xw.shape
        hdim = three_h // 3
        dh = torch.zeros((d, b, hdim))
        dxw = torch.empty((d, b, t, three_h), dtype=torch.bfloat16)
        r_all = torch.empty((d, b, t, hdim), dtype=torch.bfloat16)
        for s in reversed(range(t)):
            hw = bmm(hp[:, :, s], w) + bias
            x_t = xw[:, :, s]
            hn = hw[..., 2 * hdim:]
            r = torch.sigmoid(x_t[..., :hdim] + hw[..., :hdim])
            z = torch.sigmoid(x_t[..., hdim:2 * hdim]
                              + hw[..., hdim:2 * hdim])
            n = torch.tanh(x_t[..., 2 * hdim:] + r * hn)
            dht = g[:, :, s] + dh
            dz = dht * (hp[:, :, s] - n) * z * (1. - z)
            dpn = dht * (1. - z) * (1. - n * n)
            dpr = dpn * hn * r * (1. - r)
            dxw[:, :, s] = torch.cat([dpr, dz, dpn], dim=-1).to(
                torch.bfloat16)
            r_all[:, :, s] = r.to(torch.bfloat16)
            dgates = torch.cat([dpr, dz, dpn * r], dim=-1).to(
                torch.bfloat16)
            dh = dht * z + bmm(dgates.float(), w.transpose(1, 2))
        dgates = torch.cat([dxw[..., :2 * hdim],
                            dxw[..., 2 * hdim:] * r_all], dim=-1).double()
        dw_hh = torch.einsum('dbth,dbtg->dhg', hp.double(), dgates).float()
        return dxw, dw_hh, dgates.sum((1, 2)).float(), dh

    kg.gru_scan_plain, kg.gru_scan_bwd_plain = forward, backward
    try:
        yield
    finally:
        kg.gru_scan_plain, kg.gru_scan_bwd_plain = plain


def _card_vs_cpu(make_model, stft, k, strong=False, conv_order=False,
                 gru_order=False):
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
    CPU's own batch orders. With ``conv_order`` the CPU's noise also
    holds its step in the first order with the convs summed in f64
    (:func:`_convs_summed_in_f64`; phase 14: a bf16 max pool over 2 x 2
    windows of conv outputs ties often, and the card's convs, which sum
    in another order, break ties that the CPU's batch orders, which only
    move the norms' statistics, keep); with ``gru_order`` that step's
    plain GRU sums in f64 too (:func:`_gru_summed_in_f64`; phase 15: the
    kernels' other summation order above H = 512 flips bf16 roundings of
    h and dgates over 100 steps, which no batch order of the CPU's
    moves)."""
    batch = _train_batches(stft, 1, 4, 2, seed=3, k=k, strong=strong)[0]
    orders = ([0, 1, 2, 3], [3, 2, 1, 0], [1, 2, 3, 0], [2, 3, 0, 1])
    runs = [('cuda', orders[0])] + [('cpu', order) for order in orders]
    if conv_order or gru_order:
        runs.append(('cpu_f64_convs', orders[0]))
    grads, losses = [], []
    for device, order in runs:
        model = make_model(augment=False).to(device.split('_')[0])
        model.module.train()
        clips = {key: value[order].copy() for key, value in batch.items()}
        with contextlib.ExitStack() as sums:
            if device == 'cpu_f64_convs' and conv_order:
                sums.enter_context(_convs_summed_in_f64())
            if device == 'cpu_f64_convs' and gru_order:
                sums.enter_context(_gru_summed_in_f64())
            loss, _ = model.loss(model.to_device(clips))
            loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.detach().float().cpu()
                      for n, p in model.module.named_parameters()})
    bn_fed = bn_fed_biases(model.module)
    card, cpu, others = grads[0], grads[1], grads[2:]
    log(f'card vs CPU, B=4 T=100 step: loss {losses[0]:.6f} vs '
        f'{losses[1]:.6f} (CPU in other batch orders'
        + (', the last with its '
           + ' and '.join(name for name, on in (('convs', conv_order),
                                                ('GRU', gru_order)) if on)
           + ' summed in f64' if conv_order or gru_order else '')
        + ': ' + ', '.join(f'{x:.6f}' for x in losses[2:]) + ')')
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
    torch.cuda.synchronize()
    walls = []

    def step():
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))

    rows = profile_kernels(step)
    wall = walls[0]
    total = sum(ms for ms, _, _ in rows)
    families = {
        'conv fwd/dx wgmma': ('conv2d_wgmma_kernel',),
        'conv dw wgmma': ('conv2d_dw_wgmma_kernel',),
        'conv entry': ('conv2d_entry_kernel', 'conv2d_dw_entry_kernel',
                       'conv2d_dw_entry_reduce_kernel'),
        'conv dw reduce': ('conv2d_dw_reduce_kernel',),
        'GRU fwd': ('gru_scan_kernel', 'gru_scan_cluster_kernel'),
        'GRU bwd': ('gru_bwd',),
        'pools': ('maxpool_freq2', 'avgpool_freq2', 'maxpool2d',
                  'avgpool2d')}
    by_family = {name: sum(ms for ms, key, _ in rows
                           if any(k in key for k in keys))
                 for name, keys in families.items()}
    mine = sum(by_family.values())
    log(f'{label} profiled step: wall {wall:.1f} ms (profiler on), kernels '
        f'busy {total:.1f} ms (idle share {100 * (1 - total / wall):.0f}%), '
        f'hand-written kernels {mine:.1f} ms '
        f'({100 * mine / max(total, 1e-9):.0f}% of busy)')
    log(f'{label} profiled step by family: ' + ', '.join(
        f'{name} {ms:.2f}' for name, ms in by_family.items())
        + f', PyTorch and libraries {total - mine:.2f} ms')
    for ms, key, count in rows[:15]:
        log(f'  {ms:8.2f} ms  x{count:<5d} {key[:90]}')


# Trainer settings per recipe: classes, Adam, strong loss weight. Deep:
# the AudioSet recipe (experiments/weak_label_crnn/training.py:118-151).
_DEEP_RECIPE = {'net': 'deep', 'k': 527,
                'adam': {'lr': 1e-4, 'gradient_clipping': .1}, 'strong': 0.}
# Strong: the tag-conditioned BiCRNN with the DESED strong recipe's
# settings (experiments/strong_label_crnn/training.py: lr 5e-4 with a
# ramp, no clipping).
RECIPES = {
    'shallow': {'net': 'shallow', 'k': 10, 'adam': {'lr': 5e-4},
                'strong': 1., 'fuse_bn': False, 'kernels': SHALLOW},
    'deep': dict(_DEEP_RECIPE, fuse_bn=False, kernels=DEEP),
    'deep_fuse_bn': dict(_DEEP_RECIPE, fuse_bn=True, kernels=DEEP + FUSED),
    'strong': {'net': 'shallow', 'k': 10, 'adam': {'lr': 5e-4},
               'bicrnn': True, 'kernels': SHALLOW},
}


def _strong_config(k=10, augment=True, tag_conditioning=True,
                   eval_segment_length=1):
    """``bicrnn_config('shallow')`` at full width with ``k`` classes."""
    from pb_sed_tpu_torch.models.net_configs import bicrnn_config
    config = bicrnn_config('shallow', num_events=k, augment=augment,
                           tag_conditioning=tag_conditioning)
    config['eval_segment_length'] = eval_segment_length
    return config


def phase_training(recipe_name='shallow'):
    """The full-width FBCRNN (or, recipe ``strong``, the tag-conditioned
    BiCRNN) of recipe ``recipe_name`` trained on the card through
    ``Trainer``; returns the kernels' launch counts of that run and its
    steps/s, clips/s and peak device memory."""
    from pb_sed_tpu_torch.models import base
    from pb_sed_tpu_torch.train.hooks import LRAnnealingHook
    from pb_sed_tpu_torch.train.optimizer import Adam
    from pb_sed_tpu_torch.train.trainer import Trainer
    from pb_sed_tpu_torch.utils.config import config_to_json
    from pb_sed_tpu_torch.utils.misc import dump_json
    recipe = RECIPES[recipe_name]
    strong = recipe.get('bicrnn', False)
    CRNN = _model_class(strong)

    def config(augment):
        if strong:
            return _strong_config(recipe['k'], augment)
        return _config(recipe['net'], recipe['k'], recipe['fuse_bn'],
                       augment, recipe['strong'])

    flat = _random_flat(config(True), strong)

    def make_model(augment):
        return _model(config(augment), flat, strong=strong)

    model = make_model(augment=True).to('cuda')
    stft = model.module.feature_extractor.stft
    batches = _train_batches(stft, 4, BATCH, 10, seed=1, k=recipe['k'],
                             strong=strong)
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
        collect_garbage()
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
        serve = {key: batches[0][key][:8] for key in (
            'audio_data', 'seq_len', 'tag_condition') if key in batches[0]}
        serve['example_id'] = [f'clip{j}' for j in range(8)]
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
    _card_vs_cpu(make_model, stft, recipe['k'], strong)
    return launches, metrics



# -- phase 7: the training entry point, from wav files on disk ---------------
EVENT_CLASSES = [
    'Alarm_bell_ringing', 'Blender', 'Cat', 'Dishes', 'Dog',
    'Electric_shaver_toothbrush', 'Frying', 'Running_water', 'Speech',
    'Vacuum_cleaner']
# clips per dataset, in DESED's proportions (1578 : 3470 : 2576 : 10000):
# with the recipe's repeats (10, 10, 2, 1) an epoch is 416 clips of which
# 24%, 53%, 8% and 15% come from the four sets, so the recipe's quotas at
# batch 32 (3 weak, 6 strong, 1 + 2 synthetic clips that were not mixed
# across datasets) let about ten batches an epoch through; phase 8 tunes
# on 'validation' and evaluates on 'eval_public', phase 9 pseudo-labels
# 'train_unlabel_in_domain' (each written after the sets before it, so
# those stay what the earlier phases had)
DATABASE_CLIPS = {'train_weak': 10, 'train_strong': 22,
                  'train_synthetic20': 16, 'train_synthetic21': 64,
                  'validation': 32, 'eval_public': 32,
                  'train_unlabel_in_domain': 32}
CLI_ITERATIONS, CLI_CHECKPOINT = 16, 8


def database_clips(seed, sample_rate=16000):
    """The clips of ``DATABASE_CLIPS`` from ``seed``, in order: yields
    ``(dataset, i, audio, events, onsets, offsets, seconds)``, ``audio``
    float64 at ``sample_rate``: ten seconds (every eighth clip 9.6 to 9.9
    s, one clip per dataset 6 s) holding one to three tone bursts, one
    frequency per event class, over a noise floor."""
    rng = np.random.RandomState(seed)
    clip = 0
    for name, count in DATABASE_CLIPS.items():
        for i in range(count):
            seconds = 10.
            if i % 8 == 3:
                seconds = float(rng.uniform(9.6, 9.9))
            if i == 5:
                seconds = 6.
            n = int(seconds * sample_rate)
            audio = .02 * rng.randn(n)
            events, onsets, offsets = [], [], []
            for j in range(1 + clip % 3):
                k = (clip + 3 * j) % len(EVENT_CLASSES)
                length = int(rng.uniform(1., 4.) * sample_rate)
                start = int(rng.randint(0, n - length))
                t = np.arange(length) / sample_rate
                audio[start:start + length] += .3 * np.sin(
                    2 * np.pi * 300. * 1.35 ** k * t)
                events.append(EVENT_CLASSES[k])
                onsets.append(start / sample_rate)
                offsets.append((start + length) / sample_rate)
            clip += 1
            yield name, i, audio, events, onsets, offsets, seconds


def _labels(name, events, onsets, offsets):
    """A clip's labels as the database json holds them: none for
    ``train_unlabel_in_domain``, clip-level for ``train_weak``, onsets and
    offsets (ms) in time order for the others."""
    if name == 'train_unlabel_in_domain':
        return {}
    if name == 'train_weak':
        return {'events': sorted(set(events))}
    order = np.argsort(onsets)
    return {'events': [events[o] for o in order],
            'events_start_times': [round(onsets[o], 3) for o in order],
            'events_stop_times': [round(offsets[o], 3) for o in order]}


def write_database(root, seed):
    """A DESED-shaped database under ``root`` from ``seed``: the clips of
    ``database_clips`` as 16 kHz mono int16 wav files and ``desed.json``
    with the datasets of ``DATABASE_CLIPS`` (``train_weak`` with clip-level
    labels only, ``train_unlabel_in_domain`` with none, the others with
    onsets and offsets). Returns the json's path and the bytes of audio
    written."""
    from pb_sed_tpu_torch.utils.misc import dump_json
    sample_rate = 16000
    datasets, nbytes = {}, 0
    for name, i, audio, events, onsets, offsets, seconds in database_clips(
            seed, sample_rate):
        path = Path(root) / 'audio' / name / f'{name}_{i}.wav'
        path.parent.mkdir(parents=True, exist_ok=True)
        pcm = np.clip(audio * 32767, -32768, 32767).astype('<i2')
        with wave.open(str(path), 'wb') as fid:
            fid.setnchannels(1)
            fid.setsampwidth(2)
            fid.setframerate(sample_rate)
            fid.writeframes(pcm.tobytes())
        nbytes += pcm.nbytes
        datasets.setdefault(name, {})[f'{name}_{i}'] = {
            'audio_path': str(path), 'audio_length': seconds,
            **_labels(name, events, onsets, offsets)}
    json_path = Path(root) / 'desed.json'
    dump_json({'datasets': datasets}, json_path)
    return json_path, nbytes


@contextlib.contextmanager
def timed_trainer():
    """``Trainer.train_step`` / ``validate`` / ``test_run`` wrapped to
    record, per call, the host clock after a device synchronize: yields
    ``{'steps': [(iteration, start, end, loss)], 'validate': [seconds],
    'test_run': [seconds]}``. The classes' methods are put back on exit."""
    from pb_sed_tpu_torch.train.trainer import Trainer
    record = {'steps': [], 'validate': [], 'test_run': []}
    originals = {name: getattr(Trainer, name)
                 for name in ('train_step', 'validate', 'test_run')}

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    def train_step(self, batch):
        start = clock()
        spent = sum(record['validate'])
        loss = originals['train_step'](self, batch)
        # a validation inside the step (after a checkpoint) is not the
        # step's time
        end = clock() - (sum(record['validate']) - spent)
        record['steps'].append((self.iteration, start, end, float(loss)))
        return loss

    def timed(name):
        def call(self, *args, **kwargs):
            start = clock()
            out = originals[name](self, *args, **kwargs)
            record[name].append(clock() - start)
            return out
        return call

    Trainer.train_step = train_step
    Trainer.validate = timed('validate')
    Trainer.test_run = timed('test_run')
    try:
        yield record
    finally:
        for name, fn in originals.items():
            setattr(Trainer, name, fn)


def _read_jsonl(path):
    with open(path) as fid:
        return [json.loads(line) for line in fid]


def _cli_updates(json_path, storage_dir, **more):
    stamp = Path(storage_dir).name
    updates = {
        'timestamp': stamp, 'group_name': stamp,
        'storage_dir': str(storage_dir),
        'data_provider': {'json_path': str(json_path)},
        # phase 8 runs the tuning chain itself, on both runs
        'validation_set_name': None,
        'num_iterations': CLI_ITERATIONS,
        'checkpoint_interval': CLI_CHECKPOINT,
        'summary_interval': 4,
    }
    updates.update(more)
    return updates


def check_device_warp(batch, stft):
    """``STFT.magnitude_warped`` on the card against the CPU on one batch
    of the loader: the frames' start indices equal except where the f32
    source position lies within 1e-3 of an integer, the magnitudes of the
    other frames within ``1e-4 + 1e-4 * max|ref|``."""
    audio = torch.from_numpy(batch['audio_data'])
    args = [torch.from_numpy(np.asarray(batch[key])) for key in (
        'warp_anchor_out', 'warp_anchor_in', 'seq_len_samples')]
    starts_cpu, _ = stft.warped_frame_starts(audio.shape[-1], *args)
    starts, _ = stft.warped_frame_starts(
        audio.shape[-1], *[a.cuda() for a in args])
    moved = (starts.cpu() != starts_cpu)
    ref = stft.magnitude_warped(audio, *args)
    got = stft.magnitude_warped(audio.cuda(), *[a.cuda() for a in args])
    torch.cuda.synchronize()
    err = (got.cpu() - ref).abs().amax(-1)
    tol = 1e-4 + 1e-4 * float(ref.abs().max())
    worst = float(err[~moved].max())
    log(f'device time warp vs CPU on one loader batch {tuple(ref.shape)}: '
        f'{int(moved.sum())} of {moved.numel()} frame starts differ (f32 '
        f'source position at an integer), max|d| of the others '
        f'{worst:.3e} (tol {tol:.3e})')
    if moved.sum() > .01 * moved.numel() or not worst <= tol:
        raise AssertionError('the device time warp disagrees with the CPU')
    shift = (starts_cpu.float() - torch.arange(starts_cpu.shape[1])
             * stft.shift).abs().max()
    if not shift > stft.shift:
        raise AssertionError('the batch carries no time warp')


def check_recipe(config):
    """The saved config of the CLI run is the DESED recipe as it stands,
    at the full width of the shallow FBCRNN; returns its train fetcher's
    config."""
    fetcher = config['data_provider']['train_fetcher']
    transform = config['data_provider']['train_transform']
    model_config = config['trainer']['model']
    if not (config['net_config'] == 'shallow'
            and config['batch_size'] == 32
            and fetcher['prefetch_workers'] == 2
            and fetcher['min_dataset_examples_in_batch'] == {
                'train_weak': 3, 'train_strong': 6,
                'train_synthetic20': 1, 'train_synthetic21': 2,
                'train_unlabel_in_domain': 0}
            and transform['anchor_shift_sampling_fn'] is not None
            and config['data_provider']['mix_interval'] == 1.5
            and model_config['feature_extractor']['n_time_masks'] > 0
            and model_config['cnn']['cnn_2d']['out_channels'] == [
                16, 16, 32, 32, 64, 64, 128, 128, 256]
            and model_config['rnn_fwd']['rnn']['hidden_size'] == 256):
        raise AssertionError('the run was not the DESED recipe at the '
                             'full width of the shallow FBCRNN')
    return fetcher


def phase_cli_training(in_memory, tmp):
    """Phase 7: ``experiments.weak_label_crnn.training`` on the card from
    wav files on disk, written under the directory ``tmp``. ``in_memory``
    is phase 4's metrics, printed beside this run's. Returns the launch
    counts of the first (16-iteration) run, its metrics and the two run
    directories (the first run and the one from its best checkpoint)."""
    from pb_sed_tpu_torch.data.provider import DataProvider
    from pb_sed_tpu_torch.experiments.weak_label_crnn.training import ex
    from pb_sed_tpu_torch.models import base
    from pb_sed_tpu_torch.models.base.model import default_device
    from pb_sed_tpu_torch.models.weak_label import CRNN
    from pb_sed_tpu_torch.utils.checkpoint import load_payload
    from pb_sed_tpu_torch.utils.misc import load_json
    t0 = time.perf_counter()
    json_path, nbytes = write_database(tmp / 'db', seed=7)
    log(f'database: {sum(DATABASE_CLIPS.values())} wav files, '
        f'{nbytes / 2 ** 20:.1f} MiB, {DATABASE_CLIPS} written in '
        f'{time.perf_counter() - t0:.1f} s')
    run_dir = tmp / 'exp' / 'run1'
    updates = _cli_updates(json_path, run_dir, lr_rampup_steps=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    collect_garbage()
    with timed_trainer() as record:
        t0 = time.perf_counter()
        result = ex.run(config_updates=updates)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f'launches in the CLI training run: {launches}')
    for kernel in SHALLOW:
        if launches[kernel] <= 0:
            raise AssertionError(f'kernel {kernel} never launched in '
                                 f'the CLI training run')
    if result != str(run_dir):
        raise AssertionError(f'the run returned {result}')
    fetcher = check_recipe(load_json(run_dir / '1' / 'config.json'))
    steps = record['steps']
    losses = [loss for *_, loss in steps]
    log(f'CLI loss per step: ' + ', '.join(f'{x:.5f}' for x in losses))
    if [it for it, *_ in steps] != list(range(1, CLI_ITERATIONS + 1)) \
            or not np.isfinite(losses).all():
        raise AssertionError(f'CLI training steps: {steps}')
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    log(f'CLI mean loss of steps 1-4: {first:.5f}, of steps 13-16: '
        f'{last:.5f}')
    if not last < first:
        raise AssertionError('the loss did not fall over the CLI run')
    if len(record['test_run']) != 1 or len(record['validate']) != 3:
        raise AssertionError(
            f'expected one test run and validations after iterations '
            f'8, 16 and at the end: {record}')
    # wall time from the end of step 2 to the end of step 16, the
    # loader's waits included, the validation inside it taken out
    span = steps[-1][2] - steps[1][2] - record['validate'][0]
    metrics = {
        'steps_per_s': (CLI_ITERATIONS - 2) / span,
        'step_only_ms': 1e3 * float(np.mean(
            [end - start for _, start, end, _ in steps[2:]])),
        'validate_s': list(record['validate']),
        'test_run_s': record['test_run'][0],
        'peak_gib': peak_gib, 'wall_s': wall}
    log(f'CLI step times (host clock, synchronized, validation taken '
        f'out): ' + ', '.join(f'{1e3 * (end - start):.1f}'
                              for _, start, end, _ in steps) + ' ms')
    log(f'CLI training from wav files: {metrics["steps_per_s"]:.3f} '
        f'steps/s = {BATCH * metrics["steps_per_s"]:.1f} clips/s over '
        f'iterations 3-{CLI_ITERATIONS} (loader waits included, mean '
        f'step alone {metrics["step_only_ms"]:.1f} ms) beside '
        f'{in_memory["steps_per_s"]:.3f} steps/s on in-memory batches '
        f'(phase 4, steps 3-{TRAIN_STEPS})')
    log(f'CLI seconds in validate ({DATABASE_CLIPS["validation"]} '
        f'clips): ' + ', '.join(f'{x:.3f}' for x in record['validate'])
        + f'; test_run {metrics["test_run_s"]:.3f} s; whole run '
        f'{wall:.1f} s')
    log(f'peak device memory (CLI training): {peak_gib:.2f} GiB')

    rows = _read_jsonl(run_dir / 'summary.jsonl')
    validation = [r for r in rows if r['prefix'] == 'validation']
    training = [r for r in rows if r['prefix'] == 'training']
    log(f'summary.jsonl: {len(training)} training and '
        f'{len(validation)} validation lines; macro_fscore_weak '
        f'(validation) ' + ', '.join(
            f'{r["macro_fscore_weak"]:.4f}' for r in validation))
    if len(validation) != 3 or not all(
            np.isfinite(r['macro_fscore_weak'])
            and 0. <= r['macro_fscore_weak'] <= 1.
            and r['num_examples_weak'] == DATABASE_CLIPS['validation']
            for r in validation):
        raise AssertionError(f'validation lines: {validation}')
    if not training or not all(
            np.isfinite(r['macro_fscore_weak']) and 'lwlrap_weak' in r
            for r in training):
        raise AssertionError(f'training lines: {training}')
    names = sorted(p.name for p in (run_dir / 'checkpoints').iterdir())
    if names != [f'ckpt_{CLI_ITERATIONS}.pkl',
                 'ckpt_best_macro_fscore_weak.pkl', 'ckpt_latest.pkl']:
        raise AssertionError(f'checkpoints: {names}')

    # the loader alone, and the best checkpoint served on the card
    provider = DataProvider.from_config(
        ex.build_config(updates)['data_provider'])
    provider.train_transform.label_encoder.initialize_labels()
    provider.test_transform.label_encoder.initialize_labels()
    train_set = provider.get_train_set()
    it = iter(train_set)
    first_batch = next(it)
    t0 = time.perf_counter()
    n = 0
    for batch in it:
        n += 1
        if n == 12:
            break
    loader_s = (time.perf_counter() - t0) / n
    metrics['loader_s_per_batch'] = loader_s
    log(f'loader alone: {loader_s:.4f} host s per batch of '
        f'{len(batch["example_id"])} clips over {n} batches ('
        f'{fetcher["prefetch_workers"]} prefetch workers, wav decode, '
        f'gain, mixing, targets, collate; no model); keys '
        f'{sorted(batch)}')
    for _ in it:  # run the epoch out: the prefetch threads end
        pass
    if not {'warp_anchor_out', 'warp_anchor_in', 'seq_len_samples',
            'boundary_targets'} <= set(first_batch):
        raise AssertionError(f'loader batch keys: {sorted(first_batch)}')
    if not any('+' in i for i in first_batch['example_id']):
        raise AssertionError('no mixed example in the loader batch')
    restored = CRNN.from_storage_dir(run_dir)
    if restored.device.type != default_device().type:
        raise AssertionError(f'restored on {restored.device}')
    check_device_warp(first_batch,
                      restored.module.feature_extractor.stft)
    tags = base.tagging(restored, provider.get_validate_set())
    scores = np.stack(list(tags.values()))
    log(f'best checkpoint restored on the card tags '
        f'{scores.shape[0]} validation clips: scores in '
        f'[{scores.min():.5f}, {scores.max():.5f}]')
    if scores.shape != (DATABASE_CLIPS['validation'], 1, 10) or not (
            np.isfinite(scores).all() and scores.min() >= 1e-5
            and scores.max() <= 1 - 1e-5):
        raise AssertionError('the restored checkpoint tags out of range')
    best = run_dir / 'checkpoints' / 'ckpt_best_macro_fscore_weak.pkl'
    start = load_payload(best)['model']
    del restored

    # a second run from that checkpoint, then resumed
    tuned_dir = tmp / 'exp' / 'run2'
    more = dict(init_ckpt_path=str(best), frozen_cnn_2d_layers=2,
                num_iterations=4, checkpoint_interval=4)
    ex.run(config_updates=_cli_updates(json_path, tuned_dir, **more))
    config = load_json(tuned_dir / '1' / 'config.json')
    payload = load_payload(tuned_dir / 'checkpoints' / 'ckpt_latest.pkl')
    key = 'params.cnn.cnn_2d.conv_8.kernel'
    if not (config['finetune_mode'] is True
            and config['trainer']['optimizer']['gradient_clipping'] == 1
            and config['lr_rampup_steps'] is None
            and payload['iteration'] == 4
            and not np.array_equal(payload['model'][key], start[key])):
        raise AssertionError('the run from init_ckpt_path')
    more.update(resume=True, num_iterations=8)
    ex.run(config_updates=_cli_updates(json_path, tuned_dir, **more))
    payload = load_payload(tuned_dir / 'checkpoints' / 'ckpt_latest.pkl')
    rows = _read_jsonl(tuned_dir / 'summary.jsonl')
    iterations = [r['iteration'] for r in rows
                  if r['prefix'] == 'training']
    log(f'run from init_ckpt_path (4 iterations, gradient clipping 1) '
        f'and resumed to 8: training lines at iterations {iterations}, '
        f'last loss {rows[-1]["loss"]:.5f}')
    if payload['iteration'] != 8 or payload['optimizer']['count'] != 8 \
            or iterations != [4, 8] \
            or not all(np.isfinite(r['loss']) for r in rows):
        raise AssertionError(f'the resumed run: {rows}')
    torch.cuda.empty_cache()
    return launches, metrics, (run_dir, tuned_dir)


# -- phase 8: tuning and inference on the card, from phase 7's checkpoints --
BEST = 'ckpt_best_macro_fscore_weak.pkl'
# the hyper-parameter files of a tuning run, and per file each tuned length
# with the grid of the tuning config it comes from
SCENARIO_1_GRIDS = {'window_length': 'detection_window_lengths_scenario_1',
                    'medfilt_length': 'detection_medfilt_lengths_scenario_1'}
HYPER_PARAMS = {
    'tagging_hyper_params_f.json': {},
    'boundaries_detection_hyper_params_f.json': {
        'stepfilt_length': 'boundaries_filter_lengths'},
    'sed_hyper_params_f.json': SCENARIO_1_GRIDS,
    'sed_hyper_params_psds1.json': SCENARIO_1_GRIDS,
    'sed_hyper_params_psds2.json': {
        'window_length': 'detection_window_lengths_scenario_2',
        'medfilt_length': 'detection_medfilt_lengths_scenario_2'}}
PSDS_SCENARIOS = [
    {'dtc_threshold': .7, 'gtc_threshold': .7, 'cttc_threshold': None,
     'alpha_ct': 0., 'alpha_st': 1.},
    {'dtc_threshold': .1, 'gtc_threshold': .1, 'cttc_threshold': .3,
     'alpha_ct': .5, 'alpha_st': 1.}]
MAX_EFPR = 100.
# a staircase's area sums widths in float64: a perfect class's AUC comes
# out as 100.00000000000001, so the [0, 1] checks allow this much above 1
ROUNDING = 1e-12


def pool_start_s(method):
    """Host seconds from creating a pool of 8 workers to the last one's
    answer: with ``spawn`` (the JAX package's context) each worker imports
    this script, so torch, from scratch; ``forkserver`` goes through
    ``evaluation.parallel.parallel_map``, whose server imports it once."""
    import multiprocessing as mp
    from pb_sed_tpu_torch.evaluation.parallel import parallel_map
    start = time.perf_counter()
    if method == 'spawn':
        with mp.get_context('spawn').Pool(8) as pool:
            pool.map(abs, range(8), chunksize=1)
    else:
        parallel_map(abs, range(8), (), num_jobs=8)
    return time.perf_counter() - start


@contextlib.contextmanager
def timed_chain(inference=None):
    """Record the tuning run and each inference run it chains into (or
    that follows it): host seconds (after a device synchronize), the
    evaluation pools started and their start and shutdown seconds, peak
    device memory, and per call of the inference engine
    (``models.base.inference.inference``: the model calls and their post-
    processing into score frames) the method, window lengths, clips and
    seconds, and how many members it served stacked
    (``models.base.ensemble.maybe_stack``; 0: one model, or in turn).
    ``inference`` is the inference experiment's module whose runs are
    recorded (default: the weak one). Yields the list of records, the
    tuning run's first, and the functions that open and close a record;
    the wrapped functions are put back on exit."""
    import importlib
    from pb_sed_tpu_torch.evaluation import parallel
    from pb_sed_tpu_torch.models.base import ensemble
    if inference is None:
        from pb_sed_tpu_torch.experiments.weak_label_crnn import inference
    # the module (``models.base`` exports its function of the same name)
    engine = importlib.import_module('pb_sed_tpu_torch.models.base.inference')
    original_engine, original_run = engine.inference, inference.ex.run
    original_stack = ensemble.maybe_stack
    stacked = []

    def stack(models, model_kwargs, mesh=None):
        models, model_kwargs = original_stack(models, model_kwargs, mesh)
        stacked.append(len(models[0]) if isinstance(
            models[0], ensemble.StackedEnsemble) else 0)
        return models, model_kwargs

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    def begin(name):
        if open_runs:  # the run it interrupts keeps its peak so far
            open_runs[-1]['peak_gib'] = max(
                open_runs[-1].get('peak_gib', 0.),
                torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        record = {'run': name, 'engine': [], 'nested_s': 0.,
                  'pools_at_start': dict(parallel.POOL_STATS),
                  'start': clock()}
        records.append(record)
        open_runs.append(record)
        return record

    def end(record):
        record['wall_s'] = clock() - record['start']
        record['peak_gib'] = max(record.get('peak_gib', 0.),
                                 torch.cuda.max_memory_allocated() / 2 ** 30)
        for key in ('pools', 'start_s', 'close_s'):
            record[key] = (parallel.POOL_STATS[key]
                           - record['pools_at_start'][key])
        open_runs.pop()
        if open_runs:  # the enclosing run's own time and pools exclude it
            outer = open_runs[-1]
            outer['nested_s'] += record['wall_s']
            for key in ('pools', 'start_s', 'close_s'):
                outer['pools_at_start'][key] += record[key]

    def run_engine(model, method, dataset, *args, **kwargs):
        stacked.clear()
        start = clock()
        out = original_engine(model, method, dataset, *args, **kwargs)
        seconds = clock() - start
        windows = (kwargs.get('model_kwargs') or {}).get('window_length')
        open_runs[-1]['engine'].append({
            'method': method, 'clips': len(out[0] if isinstance(out, list)
                                           else out),
            'window_length': (None if windows is None
                              else np.unique(windows).tolist()),
            'models': len(model) if isinstance(model, (list, tuple)) else 1,
            'stacked': stacked[-1] if stacked else 0, 's': seconds})
        return out

    def run_inference(config_updates=None):
        names = (config_updates or {}).get('sed_hyper_params_name',
                                           ['f', 'psds1'])
        record = begin('inference ' + (names if isinstance(names, str)
                                       else '+'.join(names)))
        try:
            return original_run(config_updates)
        finally:
            end(record)

    records, open_runs = [], []
    engine.inference = run_engine
    inference.ex.run = run_inference
    ensemble.maybe_stack = stack
    try:
        yield records, begin, end
    finally:
        engine.inference = original_engine
        inference.ex.run = original_run
        ensemble.maybe_stack = original_stack


def _log_chain_record(record):
    model_s = sum(call['s'] for call in record['engine'])
    own_s = record['wall_s'] - record['nested_s']
    log(f'{record["run"]}: {own_s:.2f} s on the host clock, of which '
        f'{model_s:.2f} s in the inference engine (model calls and their '
        f'score frames) and {own_s - model_s:.2f} s of evaluation; '
        f'{record["pools"]} pools started in {record["start_s"]:.2f} s '
        f'(shut down in {record["close_s"]:.2f} s); peak device memory '
        f'{record["peak_gib"]:.2f} GiB')
    for call in record['engine']:
        windows = ('' if call['window_length'] is None
                   else f' window {call["window_length"]}')
        lane = (f'{call["stacked"]} members stacked' if call['stacked']
                else f'{call["models"]} model(s) in turn')
        log(f'  engine {call["method"]}{windows}: {call["clips"]} clips in '
            f'{call["s"]:.3f} s = {call["clips"] / call["s"]:.1f} clips/s, '
            f'{lane}')
    return {'run': record['run'], 'own_s': own_s, 'model_s': model_s,
            'evaluation_s': own_s - model_s, 'pools': record['pools'],
            'pool_start_s': record['start_s'],
            'pool_close_s': record['close_s'],
            'peak_gib': record['peak_gib'],
            'engine': [dict(call) for call in record['engine']]}


def _check_hyper_params(hp_dir, files=None):
    """Every hyper-parameter file of ``files`` (default ``HYPER_PARAMS``),
    every threshold in [0, 1] or at an end of its sweep (-inf: every clip
    tagged; +inf: no threshold met the boundaries' min_precision of .8, the
    reference's answer; 1e-3 beyond the lowest or highest score: the
    collar sweep's ends, every frame detected, or none), every length from
    its grid in the tuning config, every F and AUC (over ``MAX_EFPR``) in
    [0, 1] (up to ``ROUNDING``)."""
    from pb_sed_tpu_torch.utils.misc import load_json
    config = load_json(hp_dir / '1' / 'config.json')
    for name, grids in (files or HYPER_PARAMS).items():
        path = hp_dir / name
        if not path.exists():
            raise AssertionError(f'no {path}')
        for event_class, values in load_json(path).items():
            threshold = values['threshold']
            if not (-1e-3 <= threshold <= 1. + 1e-3
                    or abs(threshold) == np.inf):
                raise AssertionError(f'{name} {event_class}: threshold '
                                     f'{threshold}')
            for key, grid in grids.items():
                if values[key] not in config[grid]:
                    raise AssertionError(f'{name} {event_class}: {key} '
                                         f'{values[key]} not in {grid}')
            for metric in ('f', 'auc', 'auc1', 'auc2'):
                value = values.get(metric, 0.)
                value = value if metric == 'f' else value / MAX_EFPR
                if not (np.isfinite(value) and 0. <= value <= 1. + ROUNDING):
                    raise AssertionError(f'{name} {event_class}: {metric} '
                                         f'{values.get(metric)}')
    return config


def _check_results(run_dir):
    """Every results file of an inference run: all values finite; F-scores,
    precisions, recalls, PSDS and AUC (over ``MAX_EFPR``) in [0, 1] (up to
    ``ROUNDING``).
    Returns {file name: values}."""
    from pb_sed_tpu_torch.utils.misc import load_json
    results = {}
    for path in sorted(run_dir.glob('*_results_*.json')):
        values = load_json(path)
        for key, value in values.items():
            scaled = value / MAX_EFPR if 'auc[' in key else value
            bounded = (key.endswith(('_f', '_p', '_r')) or 'psds' in key
                       or 'auc[' in key)
            if not np.isfinite(value) or (
                    bounded and not 0. <= scaled <= 1. + ROUNDING):
                raise AssertionError(f'{path.name}: {key} = {value}')
        results[path.name] = values
    if not results:
        raise AssertionError(f'no results in {run_dir}')
    return results


def phase_tuning_chain(tmp, runs):
    """Phase 8: ``experiments.weak_label_crnn.tuning`` on the card (the
    recipe's grids, ``num_jobs=8``, batch 16 as the training CLI's chain
    passes it) on phase 7's run directories ``runs`` (both members where
    both hold the best checkpoint, else the first), chained into inference
    on ``eval_public`` for PSDS scenarios 1 and 2; then one more inference
    run with score and detection files and weak and strong
    pseudo-labels. Everything goes under ``tmp``. Returns the launch
    counts of the phase and its measurements."""
    from pb_sed_tpu_torch.data.provider import DataProvider
    from pb_sed_tpu_torch.evaluation import parallel
    from pb_sed_tpu_torch.evaluation.intersection_based import psds
    from pb_sed_tpu_torch.evaluation.scores import lazy_sed_scores_loader
    from pb_sed_tpu_torch.experiments.weak_label_crnn import (inference,
                                                             tuning)
    from pb_sed_tpu_torch.utils.misc import load_json
    members = [r for r in runs if (r / 'checkpoints' / BEST).exists()]
    members = members if len(members) == len(runs) else list(runs[:1])
    # one spawn pool (9-14 s on the 8-core host of an NVIDIA H100 80GB
    # HBM3 machine), then the forkserver's first pool (the server's
    # start, which the tuning run would pay) and a second
    starts = {'spawn': [pool_start_s('spawn')],
              'forkserver': [pool_start_s('forkserver') for _ in range(2)]}
    log('pool of 8 workers, seconds to start (the first forkserver pool '
        'starts the server): ' + '; '.join(
            f'{m} ' + ', '.join(f'{s:.3f}' for s in v)
            for m, v in starts.items()))
    saved_root = inference.storage_root
    inference.storage_root = tmp / 'exp'
    try:
        build.reset_launches()
        parallel.reset_pool_stats()
        collect_garbage()
        with timed_chain() as (records, begin, end):
            record = begin('tuning')
            hp_dir = Path(tuning.ex.run(config_updates={
                'crnn_dirs': [str(r) for r in members],
                'storage_dir': str(tmp / 'exp' / 'hyper_params'),
                'data_provider': {'test_fetcher': {'batch_size': BATCH // 2}},
                'eval_set_name': 'eval_public', 'device': None}))
            end(record)
            out_dir = Path(inference.ex.run(config_updates={
                'hyper_params_dir': str(hp_dir), 'dataset_name': 'eval_public',
                'sed_hyper_params_name': ['f', 'psds1'],
                'storage_dir': str(tmp / 'exp' / 'pseudo'),
                'save_scores': True, 'save_detections': True,
                'weak_pseudo_labeling': True, 'strong_pseudo_labeling': True,
                'device': None}))
        launches = dict(build.LAUNCHES)
    finally:
        inference.storage_root = saved_root
    log(f'launches in the tuning chain: {launches}')
    for kernel, count in launches.items():
        if (count > 0) != (kernel in FORWARD):
            raise AssertionError(f'kernel {kernel} launched {count} times in '
                                 f'the tuning chain (inference only)')
    log(f'tuning members: {[str(m.relative_to(tmp)) for m in members]}')
    metrics = {'members': len(members), 'pool_start_s': starts,
               'runs': [_log_chain_record(r) for r in records]}
    # the engine's default stacks the ensemble in every call
    calls = [c for r in records for c in r['engine']]
    if len(members) > 1 and any(c['stacked'] != len(members)
                                for c in calls):
        raise AssertionError(f'the tuning chain served its {len(members)} '
                             f'members in turn: {calls}')
    log(f'tuning chain: {len(calls)} engine calls, each with '
        f'{len(members)} member(s) {"stacked" if len(members) > 1 else ""}')
    config = _check_hyper_params(hp_dir)
    grids = {key: config[key] for name in HYPER_PARAMS
             for key in HYPER_PARAMS[name].values()}
    log(f'tuning grids: {grids}')
    if [r['run'] for r in records] != [
            'tuning', 'inference f+psds1', 'inference psds2',
            'inference f+psds1']:
        raise AssertionError(f'runs: {[r["run"] for r in records]}')
    chained = sorted(p.resolve() for p in (hp_dir / 'inference').iterdir())
    for member in members:
        link = member / 'hyper_params' / hp_dir.name
        if link.resolve() != hp_dir.resolve():
            raise AssertionError(f'no symlink {link}')
    if len(chained) != 3 or out_dir.resolve() not in chained:
        raise AssertionError(f'inference symlinks: {chained}')
    for run_dir in chained:
        results = _check_results(run_dir)
        for name, values in results.items():
            if name.startswith('sed_'):
                log(f'{run_dir.name} {name}: macro F '
                    f'{values["macro_average_f"]:.4f}, PSDS1 '
                    f'{values["psds[0]"]:.4f}, PSDS2 {values["psds[1]"]:.4f}, '
                    f'approx. {values["approx_psds[0]"]:.4f} / '
                    f'{values["approx_psds[1]"]:.4f}')
    # PSDS from the last run's score files equals the first chained run's
    # in-memory value (the same models, hyper-parameters and clips)
    provider = DataProvider.from_config(config['data_provider'])
    events, _, durations = tuning.ground_truth_from_json(provider,
                                                         'eval_public')
    (first,) = [r for r in chained if r != out_dir.resolve() and (
        r / 'sed_f_results_eval_public.json').exists()]
    results = _check_results(first)
    for name in ('f', 'psds1'):
        scores = lazy_sed_scores_loader(out_dir / 'scores' / 'eval_public'
                                        / name)
        if len(scores) != DATABASE_CLIPS['eval_public']:
            raise AssertionError(f'{len(scores)} score files for {name}')
        for j, scenario in enumerate(PSDS_SCENARIOS):
            from_files = psds(scores, events, durations, **scenario,
                              num_jobs=8)[0]
            in_memory = results[f'sed_{name}_results_eval_public.json'][
                f'psds[{j}]']
            log(f'PSDS{j + 1} of {name} from its score files {from_files!r}, '
                f'in memory {in_memory!r}')
            if from_files != in_memory:
                raise AssertionError('PSDS from the score files differs')
        if not (out_dir / 'detections' / 'eval_public' / name
                / 'cbf.tsv').exists():
            raise AssertionError(f'no detections of {name}')
    database = load_json(out_dir / 'desed.json')
    labeled = database['datasets']['eval_public']
    strong = sum(t == 'strong' for ex in labeled.values()
                 for t in ex.get('label_types', []))
    log(f'pseudo-labeled eval_public: {len(labeled)} clips, '
        f'{sum(bool(ex["events"]) for ex in labeled.values())} with tags, '
        f'{strong} strong labels')
    if len(labeled) != DATABASE_CLIPS['eval_public'] or not all(
            len(ex['label_types']) == len(ex['events'])
            for ex in labeled.values()):
        raise AssertionError('the pseudo-labeled database')
    torch.cuda.empty_cache()
    return launches, metrics, hp_dir


# -- phase 9: the strong-label BiCRNN, in memory and from the weak chain ----
STRONG_BEST = 'ckpt_best_macro_fscore_strong.pkl'
# the strong tuning's hyper-parameter files, each tuned length with the
# grid of its config (experiments/strong_label_crnn/tuning.py)
STRONG_HYPER_PARAMS = {f'sed_hyper_params_{name}.json': {
    'medfilt_length': 'medfilt_lengths'} for name in ('f', 'psds1', 'psds2')}
AUDIOSET_STRONG_STEPS = 2


def _tagged(batches, seed):
    """``batches`` with a ``tag_condition`` of 0/1 tags drawn from
    ``seed`` (about 3 of 10 classes a clip)."""
    rng = np.random.RandomState(seed)
    return [dict(b, tag_condition=(rng.rand(len(b['seq_len']), 10) > .7
                                   ).astype(np.float32)) for b in batches]


def phase_strong(in_memory):
    """Phase 9a: the full-width tag-conditioned shallow BiCRNN (random
    weights from a seed, through the bridge) served on the card (tagging
    and SED of the 3 x 32 clips of phase 3 with seeded tags, against the
    CPU), trained for 8 steps with the DESED strong recipe's settings
    (phase 4's checks, steps/s beside its FBCRNN numbers), and the AudioSet
    strong configuration (456 classes, no conditioning,
    ``eval_segment_length`` 50, clipping 0.1) for 2 steps. Returns the
    measurements with the launch counts of each run."""
    from pb_sed_tpu_torch.models import base
    from pb_sed_tpu_torch.train.optimizer import Adam
    from pb_sed_tpu_torch.train.trainer import Trainer
    out = {'launches': {}}
    config = _strong_config()
    flat = _random_flat(config, strong=True)
    model = _model(config, flat, 'cuda', strong=True)
    log(f'BiCRNN shallow, tag-conditioned: {model.num_parameters()} '
        f'parameters, {len(flat)} flat tensors, GRU input '
        f'{model.module.rnn.rnn.input_size}, entry conv '
        f'{tuple(model.module.cnn.cnn_2d.conv_0.kernel.shape)}')
    batches = _tagged(_synthetic_batches(model.module.feature_extractor.stft),
                      seed=9)
    methods = [('tagging', base.tagging, {}),
               ('sound_event_detection', base.sound_event_detection, {})]
    results, out['launches']['strong_serving'] = _serve(
        model, methods, batches, 10, 'strong', low=0.)
    _agree_with_cpu(_model(config, flat, strong=True), methods, results,
                    batches[1])
    for clip, sl in zip(batches[1]['example_id'], batches[1]['seq_len']):
        tag = results['tagging'][clip][0]
        frames = results['sound_event_detection'][clip][:sl]
        if not np.allclose(tag, frames.max(0), rtol=0, atol=1e-6):
            raise AssertionError(f'{clip}: the tag is not the max over the '
                                 f'valid frames')
    del model
    torch.cuda.empty_cache()
    out['launches']['strong_training'], out['training'] = phase_training(
        'strong')
    log('training steps/s, clips/s, peak GiB (B=32, steps 3-8, host '
        'clock): BiCRNN ' + ', '.join(
            f'{out["training"][key]:.3f}' for key in (
                'steps_per_s', 'clips_per_s', 'peak_gib'))
        + ' beside the FBCRNN (phase 4) ' + ', '.join(
            f'{in_memory[key]:.3f}' for key in (
                'steps_per_s', 'clips_per_s', 'peak_gib')))

    # the AudioSet strong configuration on in-memory batches
    config = _strong_config(456, tag_conditioning=False,
                            eval_segment_length=50)
    model = _model(config, _random_flat(config, strong=True), 'cuda',
                   strong=True)
    if model.module.cnn.cnn_2d.conv_0.kernel.shape[2] != 1:
        raise AssertionError('the AudioSet configuration is conditioned')
    stft = model.module.feature_extractor.stft
    train = _train_batches(stft, AUDIOSET_STRONG_STEPS, BATCH, 10, seed=11,
                           k=456, strong=True)
    trainer = Trainer(model, optimizer=Adam(lr=1e-4, gradient_clipping=.1),
                      stop_trigger=(AUDIOSET_STRONG_STEPS, 'iteration'))
    step_log = _StepLog()
    trainer.register_hook(step_log)
    torch.cuda.synchronize()
    build.reset_launches()
    trainer.train(train)
    torch.cuda.synchronize()
    launches = out['launches']['strong_audioset_training'] = dict(
        build.LAUNCHES)
    with torch.no_grad():
        _, aux = model.loss(model.to_device(train[0]))
    n_seg = aux['buffers']['y_strong'].shape[1]
    log(f'AudioSet strong configuration, 456 classes: losses '
        f'{step_log.losses}, step times ' + ', '.join(
            f'{1e3 * x:.1f}' for x in np.diff(step_log.times))
        + f' ms, {n_seg} review segments of 50 frames, launches {launches}')
    if (len(step_log.losses) != AUDIOSET_STRONG_STEPS
            or not np.isfinite(step_log.losses).all() or n_seg != 10):
        raise AssertionError('the AudioSet strong configuration')
    for kernel in SHALLOW:
        if launches[kernel] <= 0:
            raise AssertionError(f'kernel {kernel} never launched in the '
                                 f'AudioSet strong training run')
    del trainer, model
    torch.cuda.empty_cache()
    return out


def check_strong_recipe(config):
    """The saved config of the strong CLI run is the DESED strong recipe
    as it stands at the full width of the tag-conditioned shallow
    BiCRNN."""
    fetcher = config['data_provider']['train_fetcher']
    model_config = config['trainer']['model']
    rnn = model_config['rnn']['rnn']
    if not (config['net_config'] == 'shallow'
            and config['batch_size'] == 32
            and fetcher['prefetch_workers'] == 2
            and fetcher['min_dataset_examples_in_batch'] == {
                'train_weak': 3, 'train_strong': 6,
                'train_synthetic20': 1, 'train_synthetic21': 2,
                'train_unlabel_in_domain': 0}
            and config['data_provider']['train_set'][
                'train_unlabel_in_domain'] == 2
            and config['data_provider']['train_transform'][
                'provide_strong_targets']
            and config['tag_conditioning'] is True
            and config['hyper_params_tuning_batch_size'] == 16
            and model_config['cnn']['conditional_dims'] == 10
            and model_config['cnn']['cnn_2d']['out_channels'] == [
                16, 16, 32, 32, 64, 64, 128, 128, 256]
            and model_config['feature_extractor']['n_time_masks'] > 0
            and (rnn['hidden_size'], rnn['num_layers'], rnn['input_size'],
                 rnn['bidirectional']) == (256, 2, 266, True)):
        raise AssertionError('the strong run was not the DESED recipe at '
                             'the full width of the shallow BiCRNN')


def _check_tsv(path):
    with open(path) as fid:
        lines = fid.read().splitlines()
    if not lines or lines[0] != 'filename\tonset\toffset\tevent_label':
        raise AssertionError(f'{path}: header {lines[:1]}')
    return lines[1:]


def phase_strong_chain(tmp, weak_hp_dir, in_memory):
    """Phase 9b, inside phase 7-8's directory ``tmp``: one weak inference
    run from phase 8's hyper-parameters (``weak_hp_dir``) pseudo-labels the
    32 ``train_unlabel_in_domain`` clips weakly and strongly; on that json
    ``experiments.strong_label_crnn.training`` trains the full-width
    tag-conditioned BiCRNN with the DESED recipe (batch 32, two prefetch
    workers, ``train_unlabel_in_domain: 2``) for 16 iterations with a
    checkpoint and a validation every 8 (a ramp of 4), chained into the
    strong tuning (the recipe's 12 median filters, ``num_jobs=8``, batch
    16, phase 8's weak ensemble tagging) and into inference on
    ``eval_public`` (sets f and psds1); then inference runs for psds2 and
    one that saves scores and detections and pseudo-labels
    ``train_unlabel_in_domain`` strongly. ``in_memory`` is phase 9a's
    training metrics, printed beside this run's. Returns the measurements
    with the launch counts of the training run and of the chain after
    it."""
    from pb_sed_tpu_torch.data.provider import DataProvider
    from pb_sed_tpu_torch.evaluation import parallel
    from pb_sed_tpu_torch.experiments.strong_label_crnn import (
        inference, training, tuning)
    from pb_sed_tpu_torch.experiments.weak_label_crnn import (
        inference as weak_inference)
    from pb_sed_tpu_torch.models import base
    from pb_sed_tpu_torch.models.base.model import default_device
    from pb_sed_tpu_torch.models.strong_label import CRNN
    from pb_sed_tpu_torch.utils.misc import load_json
    out = {'launches': {}}
    exp = tmp / 'exp'
    saved = (tuning.storage_root, inference.storage_root,
             weak_inference.storage_root)
    tuning.storage_root = inference.storage_root = exp
    weak_inference.storage_root = exp
    original_tuning = tuning.ex.run
    try:
        build.reset_launches()
        parallel.reset_pool_stats()
        collect_garbage()
        with timed_chain(inference) as (records, begin, end):
            # 1-2. the weak ensemble pseudo-labels the unlabeled clips
            record = begin('weak pseudo-labeling')
            pseudo_dir = Path(weak_inference.ex.run(config_updates={
                'hyper_params_dir': str(weak_hp_dir),
                'dataset_name': ['train_unlabel_in_domain'],
                'weak_pseudo_labeling': [True],
                'strong_pseudo_labeling': [True],
                'storage_dir': str(exp / 'weak_pseudo'), 'device': None}))
            end(record)
            json_path = pseudo_dir / 'desed.json'
            unlabeled = load_json(json_path)['datasets'][
                'train_unlabel_in_domain']
            label_types = [t for ex in unlabeled.values()
                           for t in ex['label_types']]
            log(f'weak pseudo-labels of train_unlabel_in_domain: '
                f'{len(unlabeled)} clips, '
                f'{sum(bool(ex["events"]) for ex in unlabeled.values())} '
                f'tagged, {label_types.count("strong")} strong and '
                f'{label_types.count("weak")} weak labels')
            if len(unlabeled) != DATABASE_CLIPS['train_unlabel_in_domain']:
                raise AssertionError('the weakly pseudo-labeled json')
            pre = dict(build.LAUNCHES)

            # 3. strong training, chained into tuning and inference
            def run_tuning(config_updates=None):
                out['launches']['strong_cli_training'] = dict(build.LAUNCHES)
                out['training_peak_gib'] = (torch.cuda.max_memory_allocated()
                                            / 2 ** 30)
                build.reset_launches()
                tuning_record = begin('strong tuning')
                try:
                    return original_tuning(config_updates)
                finally:
                    end(tuning_record)

            tuning.ex.run = run_tuning
            run_dir = exp / 'strong' / 'run1'
            updates = _cli_updates(
                json_path, run_dir, lr_rampup_steps=4,
                validation_set_name='validation',
                weak_label_crnn_hyper_params_dir=str(weak_hp_dir))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            with timed_trainer() as record:
                t0 = time.perf_counter()
                result = training.ex.run(config_updates=updates)
                wall = time.perf_counter() - t0
            tuning.ex.run = original_tuning
            # 4. the set psds2, then scores, detections and pseudo-labels
            (hp_dir,) = (exp / 'strong_label_crnn' / 'desed'
                         / 'hyper_params').iterdir()
            inference.ex.run(config_updates={
                'strong_label_crnn_hyper_params_dir': str(hp_dir),
                'sed_hyper_params_name': 'psds2', 'device': None})
            labeled_dir = Path(inference.ex.run(config_updates={
                'strong_label_crnn_hyper_params_dir': str(hp_dir),
                'sed_hyper_params_name': 'f',
                'dataset_name': ['train_unlabel_in_domain'],
                'strong_pseudo_labeling': [True], 'save_scores': True,
                'save_detections': True,
                'storage_dir': str(exp / 'strong_pseudo'), 'device': None}))
        chain = dict(build.LAUNCHES)
    finally:
        tuning.ex.run = original_tuning
        (tuning.storage_root, inference.storage_root,
         weak_inference.storage_root) = saved
    trained = out['launches']['strong_cli_training']
    out['launches']['strong_chain'] = {k: chain[k] + pre[k] for k in chain}
    log(f'launches in the strong CLI training run: {trained}; in the weak '
        f'pseudo-labeling, strong tuning and inference runs: '
        f'{out["launches"]["strong_chain"]}')
    for kernel in SHALLOW:
        if trained[kernel] <= 0:
            raise AssertionError(f'kernel {kernel} never launched in the '
                                 f'strong CLI training run')
    for kernel, count in out['launches']['strong_chain'].items():
        if (count > 0) != (kernel in FORWARD):
            raise AssertionError(f'kernel {kernel} launched {count} times in '
                                 f'the strong tuning chain (inference only)')
    if result != str(run_dir):
        raise AssertionError(f'the strong run returned {result}')
    check_strong_recipe(load_json(run_dir / '1' / 'config.json'))

    # the training run: steps, losses, validation, the best checkpoint
    steps = record['steps']
    losses = [loss for *_, loss in steps]
    log('strong CLI loss per step: ' + ', '.join(f'{x:.5f}' for x in losses))
    if [it for it, *_ in steps] != list(range(1, CLI_ITERATIONS + 1)) \
            or not np.isfinite(losses).all():
        raise AssertionError(f'strong CLI training steps: {steps}')
    span = steps[-1][2] - steps[1][2] - record['validate'][0]
    metrics = {
        'steps_per_s': (CLI_ITERATIONS - 2) / span,
        'step_only_ms': 1e3 * float(np.mean(
            [end_ - start for _, start, end_, _ in steps[2:]])),
        'validate_s': list(record['validate']),
        'test_run_s': record['test_run'][0], 'wall_s': wall}
    log(f'strong CLI training from wav files and pseudo-labels: '
        f'{metrics["steps_per_s"]:.3f} steps/s = '
        f'{BATCH * metrics["steps_per_s"]:.1f} clips/s over iterations '
        f'3-{CLI_ITERATIONS} (loader waits included, mean step alone '
        f'{metrics["step_only_ms"]:.1f} ms) beside '
        f'{in_memory["steps_per_s"]:.3f} steps/s on in-memory batches '
        f'(phase 9a); seconds in validate ' + ', '.join(
            f'{x:.3f}' for x in record['validate'])
        + f'; training, tuning and chained inference {wall:.1f} s; peak '
        f'device memory in training {out["training_peak_gib"]:.2f} GiB')
    rows = _read_jsonl(run_dir / 'summary.jsonl')
    validation = [r for r in rows if r['prefix'] == 'validation']
    log('strong summary.jsonl: macro_fscore_strong (validation) '
        + ', '.join(f'{r["macro_fscore_strong"]:.4f}' for r in validation)
        + '; strong_label_rate (training) ' + ', '.join(
            f'{r["strong_label_rate"]:.3f}' for r in rows
            if r['prefix'] == 'training'))
    if not validation or not all(
            np.isfinite(r['macro_fscore_strong'])
            and 0. <= r['macro_fscore_strong'] <= 1. for r in validation):
        raise AssertionError(f'strong validation lines: {validation}')
    names = sorted(p.name for p in (run_dir / 'checkpoints').iterdir())
    if STRONG_BEST not in names:
        raise AssertionError(f'strong checkpoints: {names}')
    restored = CRNN.from_storage_dir(run_dir, checkpoint_name=STRONG_BEST)
    if restored.device.type != default_device().type:
        raise AssertionError(f'restored on {restored.device}')
    provider = DataProvider.from_config(
        load_json(run_dir / '1' / 'config.json')['data_provider'])
    provider.test_transform.label_encoder.initialize_labels()
    scores = base.sound_event_detection(
        restored, provider.get_validate_set().map(training.add_tag_condition))
    values = np.concatenate([v.ravel() for v in scores.values()])
    log(f'best strong checkpoint restored on the card scores '
        f'{len(scores)} validation clips: frame scores in '
        f'[{values.min():.5f}, {values.max():.5f}]')
    if len(scores) != DATABASE_CLIPS['validation'] or not (
            np.isfinite(values).all() and 0. <= values.min()
            and values.max() <= 1.):
        raise AssertionError('the restored strong checkpoint')
    del restored

    # tuning and inference
    config = _check_hyper_params(hp_dir, STRONG_HYPER_PARAMS)
    log(f'strong tuning: median filters {config["medfilt_lengths"]}, '
        f'batch {config["data_provider"]["test_fetcher"]["batch_size"]}, '
        f'weak members {len(config["weak_label_crnn_dirs"])}')
    calls = [c for r in records for c in r['engine']]
    ensembles = [c for c in calls if c['models'] > 1]
    if any(c['stacked'] != c['models'] for c in ensembles):
        raise AssertionError(f'the strong chain served an ensemble in turn: '
                             f'{ensembles}')
    log(f'strong chain: {len(ensembles)} engine calls served the weak '
        f'ensemble stacked, {len(calls) - len(ensembles)} one model')
    if [r['run'] for r in records] != [
            'weak pseudo-labeling', 'strong tuning', 'inference f+psds1',
            'inference psds2', 'inference f']:
        raise AssertionError(f'runs: {[r["run"] for r in records]}')
    if (run_dir / 'hyper_params' / hp_dir.name).resolve() != hp_dir.resolve():
        raise AssertionError('no symlink from the strong run to its tuning')
    chained = sorted(p.resolve() for p in (hp_dir / 'inference').iterdir())
    if len(chained) != 3:
        raise AssertionError(f'strong inference symlinks: {chained}')
    for run in chained:
        if run == labeled_dir.resolve():
            continue
        for name, values in _check_results(run).items():
            log(f'{run.name} {name}: macro F '
                f'{values.get("macro_average_f", float("nan")):.4f}, PSDS1 '
                f'{values["psds[0]"]:.4f}, PSDS2 {values["psds[1]"]:.4f}, '
                f'approx. {values["approx_psds[0]"]:.4f} / '
                f'{values["approx_psds[1]"]:.4f}')
    rows = _check_tsv(
        labeled_dir / 'train_unlabel_in_domain_pseudo_labeled.tsv')
    database = load_json(labeled_dir / 'desed.json')
    relabeled = database['datasets']['train_unlabel_in_domain']
    strong_labels = sum(t == 'strong' for ex in relabeled.values()
                        for t in ex['label_types'])
    n_scores = len(list((labeled_dir / 'scores' / 'train_unlabel_in_domain'
                         / 'f').iterdir()))
    log(f'strong pseudo-labels of train_unlabel_in_domain: {len(rows)} TSV '
        f'rows, {strong_labels} strong labels, {n_scores} score files')
    if (len(relabeled) != DATABASE_CLIPS['train_unlabel_in_domain']
            or n_scores != len(relabeled) or not (
                labeled_dir / 'detections' / 'train_unlabel_in_domain' / 'f'
                / 'cbf.tsv').exists()):
        raise AssertionError('the strongly pseudo-labeled set')
    out['training'] = metrics
    out['runs'] = [_log_chain_record(r) for r in records]
    out['peak_gib'] = max(r['peak_gib'] for r in records)
    torch.cuda.empty_cache()
    return out


# -- phase 10: the stacked ensemble --------------------------------------
# per conv layer and member count: the member-axis launch beside M single
# launches, the plain version, cuDNN's grouped conv and the bound (JSON)
MEMBER_ROWS = []
# per GRU shape at D = 2N: both designs' ms and the one the rule takes
MEMBER_GRU_ROWS = []


def member_conv_work(m, p, cin, cout, affine=False):
    """Bytes and operations of M members' SAME 3x3 convs over ``p``
    pixels each (every member's activations, weights, bias and, fused,
    scale and shift read once, its output written once)."""
    nbytes = m * (2 * p * cin + 2 * 9 * cin * cout + 4 * cout + 2 * p * cout
                  + (8 * cin if affine else 0))
    return bound(nbytes, m * 2. * p * 9 * cin * cout,
                 m * 3. * p * cin if affine else 0.)


def _grouped(x, w, b):
    """cuDNN's grouped bf16 conv of M members (the library call, timing
    only): x (M, B, T, F, Cin) as one (B, M Cin, T, F) channels-last
    input, w as (M Cout, Cin, 3, 3), ``groups=M``."""
    m, bsz, t, f, cin = x.shape
    xn = _nchw(x.permute(1, 2, 3, 0, 4).reshape(bsz, t, f, m * cin)
               .contiguous())
    wn = w.to(torch.bfloat16).permute(0, 4, 3, 1, 2).reshape(
        m * w.shape[-1], cin, 3, 3).contiguous(
            memory_format=torch.channels_last)
    return lambda: F.conv2d(xn, wn, b.reshape(-1).to(torch.bfloat16),
                            padding=1, groups=m)


def check_member_kernels(records, label, seed, m, convs, fused):
    """The member-axis conv forward (plain and BN+ReLU-fused at the layers
    ``fused``) at ``m`` members and one model's shapes (B=32, T=500): ONE
    launch must equal m single launches in every bit (each tile's K order
    does not depend on M) and lie within the conv's tolerance of the
    plain version; logged per layer with the ms of the member-axis
    launch, of m single launches, of the plain version, of cuDNN's grouped
    conv (plain conv only; the fused one has no single library call) and
    the bound. The errors join the kernels' ``max_abs_err``, the times the
    records' ``member_*`` sums."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    for layer, f, cin, cout in convs:
        design = conv_designs(f, cin, cout)['fwd']['design']
        if design != ('entry' if cin < 16 else 'wgmma'):
            raise AssertionError(f'{label} {layer} at M = {m}: the member-'
                                 f'axis forward runs {design}')
        x = randn(m, BATCH, FRAMES, f, cin).to(torch.bfloat16)
        w = randn(m, 3, 3, cin, cout, scale=(9 * cin) ** -.5)
        b = randn(m, cout, scale=.1)
        scale = .5 + torch.rand(m, cin, generator=gen, device=dev)
        shift = randn(m, cin, scale=.5)
        p = BATCH * FRAMES * f
        runs = [('conv2d_same', conv2d_same_members, conv2d_same,
                 conv2d_same_members_plain, (), _grouped(x, w, b))]
        if layer in fused:
            runs.append(('bnrelu_conv2d_same', bnrelu_conv2d_same_members,
                         bnrelu_conv2d_same, bnrelu_conv2d_same_members_plain,
                         (scale, shift), None))
        for name, members, single, plain, pre, library in runs:
            def singles():
                return torch.stack([single(x[i], *(a[i] for a in pre), w[i],
                                           b[i]) for i in range(m)])
            got = members(x, *pre, w, b)
            if not torch.equal(got, singles()):
                raise AssertionError(f'{name} {layer} at M = {m}: one '
                                     f'member-axis launch differs from '
                                     f'{m} single launches')
            ref = plain(x, *pre, w, b)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tol = 2. ** -7 * float(ref.float().abs().max())
            del got, ref
            work = member_conv_work(m, p, cin, cout, affine=bool(pre))
            row = {'tower': label, 'layer': layer, 'members': m, 'F': f,
                   'Cin': cin, 'Cout': cout, 'kernel': name,
                   'max_abs_err': err, 'tol': tol,
                   'ms': cuda_ms(lambda: members(x, *pre, w, b), reps=5),
                   'singles_ms': cuda_ms(singles, reps=5),
                   'plain_ms': cuda_ms(lambda: plain(x, *pre, w, b),
                                       reps=2, warmup=1),
                   'library_ms': (None if library is None
                                  else cuda_ms(library, reps=5)),
                   'bound_ms': work[0], 'bound_by': work[1]}
            lib = ('' if row['library_ms'] is None
                   else f', cuDNN grouped {row["library_ms"]:.3f}')
            log(f'{name} members {label} {layer} (M={m}, {BATCH}, {FRAMES},'
                f' {f}, {cin} -> {cout}): bit-equal to {m} single launches;'
                f' max|d| vs plain {err:.3e} tol {tol:.3e}; one launch '
                f'{row["ms"]:.3f} ms, {m} launches {row["singles_ms"]:.3f}, '
                f'plain {row["plain_ms"]:.3f}{lib}, bound '
                f'{work[0]:.3f} ({work[1]})')
            if not err <= tol:
                raise AssertionError(f'{name} {layer} at M = {m}: kernel '
                                     f'differs from plain by {err} > {tol}')
            rec = records[name]
            rec['max_abs_err'] = max(rec['max_abs_err'], err)
            for key in ('ms', 'singles_ms', 'plain_ms', 'library_ms',
                        'bound_ms'):
                if row[key] is not None:
                    _add(rec, f'member_{label}_{key}', row[key])
            MEMBER_ROWS.append(row)
        del x
        torch.cuda.empty_cache()


def _gru_inputs(d, b, t, h, gen):
    """Random GRU inputs at (D, B, T, H) on the card."""
    dev = torch.device('cuda')
    xw = torch.randn(d, b, t, 3 * h, generator=gen, device=dev).to(
        torch.bfloat16)
    w_hh = torch.randn(d, h, 3 * h, generator=gen, device=dev) * h ** -.5
    b_hh = torch.randn(d, 3 * h, generator=gen, device=dev) * .1
    return xw, w_hh, b_hh, torch.zeros(d, b, h, device=dev)


def check_member_gru(records):
    """The GRU forward at D = 2N (``ENSEMBLE_GRU_SHAPES``) under both
    designs (``scripts/perf/gru_designs.py``'s ``scan_as``, which the
    port's library does not export), each against the plain version
    (5.3e-3), with the ms of each and of the plain version, the design
    the rule takes (``gru_cluster_takes``) and the bound; the errors join
    ``max_abs_err``. No single library call runs D independent GRUs."""
    import importlib.util
    path = Path(__file__).resolve().parent / 'scripts/perf/gru_designs.py'
    spec = importlib.util.spec_from_file_location('gru_designs', path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    scan_as = probe.scan_as
    gen = torch.Generator(device='cuda').manual_seed(11)
    for d, b, t, h in ENSEMBLE_GRU_SHAPES:
        xw, w_hh, b_hh, h0 = _gru_inputs(d, b, t, h, gen)
        ref = gru_scan_plain(xw, w_hh, b_hh, h0)
        row = {'shape': (d, b, t, h), 'tiles16': d * -(-b // 16),
               'takes': gru_designs(d, b, t, h)['fwd']['design'],
               'bound_ms': gru_work(d, b, t, h)[0],
               'plain_ms': cuda_ms(lambda: gru_scan_plain(xw, w_hh, b_hh,
                                                          h0),
                                   reps=1, warmup=0)}
        for design in ('cluster', 'row_tiled'):
            y = scan_as(design, xw, w_hh, b_hh, h0)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            del y
            if not err <= 5.3e-3:
                raise AssertionError(f'gru_scan {design} at {(d, b, t, h)} '
                                     f'differs from plain by {err}')
            records['gru_scan']['max_abs_err'] = max(
                records['gru_scan']['max_abs_err'], err)
            row[f'{design}_ms'] = cuda_ms(
                lambda: scan_as(design, xw, w_hh, b_hh, h0), reps=3)
            row[f'{design}_max_abs_err'] = err
        rec = records['gru_scan']
        _add(rec, 'member_ms', row[f'{row["takes"]}_ms'])
        _add(rec, 'member_cluster_ms', row['cluster_ms'])
        _add(rec, 'member_row_tiled_ms', row['row_tiled_ms'])
        _add(rec, 'member_bound_ms', row['bound_ms'])
        _add(rec, 'member_plain_ms', row['plain_ms'])
        faster = min(('cluster', 'row_tiled'), key=lambda k: row[f'{k}_ms'])
        log(f'gru_scan at D = 2N {(d, b, t, h)} ({row["tiles16"]} row tiles '
            f'of 16): cluster {row["cluster_ms"]:.3f} ms, row-tiled '
            f'{row["row_tiled_ms"]:.3f} ms (max|d| vs plain '
            f'{row["cluster_max_abs_err"]:.2e}, '
            f'{row["row_tiled_max_abs_err"]:.2e}); the rule takes '
            f'{row["takes"]}, the faster is {faster}; plain '
            f'{row["plain_ms"]:.3f} ms, bound {row["bound_ms"]:.3f} ms')
        MEMBER_GRU_ROWS.append(row)
        del xw, ref
        torch.cuda.empty_cache()


# (D, B, T, H) of every stacked GRU forward (D > 2) that the paths gave
# the kernel while recording_gru_shapes was on
STACKED_GRU_SEEN = set()


@contextlib.contextmanager
def recording_gru_shapes():
    """Record in ``STACKED_GRU_SEEN`` the shape of every ``gru_scan`` call
    with D > 2 (a stacked ensemble's members folded into D) while on."""
    from pb_sed_tpu_torch.ops.kernels import gru as kgru
    original = kgru.gru_scan

    def recorded(xw, w_hh, b_hh, h0):
        d, b, t, g = xw.shape
        if d > 2:
            STACKED_GRU_SEEN.add((d, b, t, g // 3))
        return original(xw, w_hh, b_hh, h0)

    kgru.gru_scan = recorded
    try:
        yield
    finally:
        kgru.gru_scan = original


def check_stacked_gru_shapes(records):
    """Phase 10c: every stacked GRU forward shape the main path gave the
    kernel (``STACKED_GRU_SEEN``: phases 8, 9b and 10b) that phase 10a did
    not hold against the plain version already: ``gru_scan`` under the
    design the rule takes there, against the plain version (5.3e-3) on
    random inputs of that shape. It fails unless the recording saw the
    shapes phase 10b must give: 10 members' tagging and 3 deep ones' at
    H = 512. Returns the rows logged."""
    must = {(2 * ENSEMBLE_MEMBERS, BATCH, FRAMES, 256),
            (2 * DEEP_MEMBERS, BATCH, FRAMES, 512)}
    if not must <= STACKED_GRU_SEEN:
        raise AssertionError(f'stacked GRU shapes recorded: '
                             f'{sorted(STACKED_GRU_SEEN)}, missing '
                             f'{sorted(must - STACKED_GRU_SEEN)}')
    gen = torch.Generator(device='cuda').manual_seed(12)
    rows = []
    for d, b, t, h in sorted(STACKED_GRU_SEEN - set(ENSEMBLE_GRU_SHAPES)):
        xw, w_hh, b_hh, h0 = _gru_inputs(d, b, t, h, gen)
        ref = gru_scan_plain(xw, w_hh, b_hh, h0)
        y = gru_scan(xw, w_hh, b_hh, h0)
        err = float((y - ref).abs().max())
        design = gru_designs(d, b, t, h)['fwd']
        rows.append({'shape': (d, b, t, h), 'design': design['design'],
                     'rows': design['rows'], 'max_abs_err': err})
        if not err <= 5.3e-3:
            raise AssertionError(f'gru_scan at {(d, b, t, h)} '
                                 f'({design["design"]}) differs from plain '
                                 f'by {err}')
        records['gru_scan']['max_abs_err'] = max(
            records['gru_scan']['max_abs_err'], err)
        del xw, y, ref
    torch.cuda.empty_cache()
    log(f'stacked GRU shapes of phases 8, 9b and 10b against the plain '
        f'version, beyond phase 10a\'s: {len(rows)} shapes, max|d| '
        f'{max((r["max_abs_err"] for r in rows), default=0.):.2e} (tol '
        f'5.3e-3): ' + '; '.join(f'{r["shape"]} {r["design"]} '
                                 f'{r["rows"]} rows' for r in rows))
    return rows


def _members(config, n, seed0=0):
    """``n`` models of ``config`` on the card, member i with the seeded
    random weights of seed ``seed0 + i``."""
    return [_model(config, _random_flat(config, seed=seed0 + i), 'cuda')
            for i in range(n)]


def _lanes(members, methods, batches, k, label, expected):
    """Serve ``methods`` stacked (the engine's default, which runs
    sliding-window SED in chunks of ceil(clips / members)) and with the
    members in turn (``auto_stack=False``); the two within 1e-4 +
    3e-2 * max|ref| on every clip (the deviation logged); clips/s, peak
    memory and launches of both. The stacked lane launches each kernel
    once per layer and forward (one forward a batch, or a chunk), whatever
    the members: per method its launches of each kernel in ``expected``
    must be ``expected[kernel]`` a forward, and of every kernel the
    in-turn lane's divided by the members (times the chunks a batch).
    Returns (the measurements, the stacked lanes' launches summed over
    the methods)."""
    n = len(members)
    out = {}
    total = {name: 0 for name in KERNELS}
    for name, fn, kwargs in methods:
        windows = 'window_length' in kwargs.get('model_kwargs', {})
        lanes = {}
        for lane, extra in (('stacked', {}),
                            ('in_turn', {'auto_stack': False})):
            stats = {}
            results, launches = _serve(members, [(name, fn, kwargs | extra)],
                                       batches, k, f'{label} {lane}',
                                       stats=stats)
            lanes[lane] = (results[name], launches, stats)
        chunks = -(-BATCH // -(-BATCH // n)) if windows else 1
        forwards = len(batches) * chunks
        stacked_launches = lanes['stacked'][1]
        for kernel, per_forward in expected.items():
            if stacked_launches[kernel] != per_forward * forwards:
                raise AssertionError(
                    f'{label} {name} stacked: {kernel} launched '
                    f'{stacked_launches[kernel]} times for {forwards} '
                    f'forwards, not {per_forward} each')
        for kernel, count in stacked_launches.items():
            total[kernel] += count
            if count * n != lanes['in_turn'][1][kernel] * chunks:
                raise AssertionError(
                    f'{label} {name}: {kernel} launched {count} times '
                    f'stacked, {lanes["in_turn"][1][kernel]} in turn by '
                    f'{n} members')
        worst, worst_err = 0., 0.
        for clip, ref in lanes['in_turn'][0].items():
            got = lanes['stacked'][0][clip]
            err = float(np.abs(got - ref).max())
            tol = 1e-4 + 3e-2 * float(np.abs(ref).max())
            worst, worst_err = max(worst, err / tol), max(worst_err, err)
            if not err <= tol:
                raise AssertionError(f'{label} {name} {clip}: stacked and '
                                     f'in-turn scores differ by {err} > '
                                     f'{tol}')
        row = {'members': n, 'max_abs_dev': worst_err,
               'worst_dev_over_tol': worst}
        for lane, (_, launches, stats) in lanes.items():
            row[lane] = {'clips_per_s': stats[f'{name}_clips_per_s'],
                         'peak_gib': stats['peak_gib'],
                         'launches_per_batch': {
                             key: v / len(batches)
                             for key, v in launches.items() if v}}
        stacked_cps = row['stacked']['clips_per_s']
        in_turn_cps = row['in_turn']['clips_per_s']
        log(f'{label} {name}, {n} members: stacked {stacked_cps:.1f} '
            f'clips/s vs in turn {in_turn_cps:.1f} '
            f'({stacked_cps / in_turn_cps:.2f}x);'
            f' peak {row["stacked"]["peak_gib"]:.2f} vs '
            f'{row["in_turn"]["peak_gib"]:.2f} GiB; launches a batch '
            f'{row["stacked"]["launches_per_batch"]} vs '
            f'{row["in_turn"]["launches_per_batch"]}; max|stacked - in '
            f'turn| {worst_err:.3e} ({worst:.3f} of the tolerance)')
        out[name] = row
    return out, total


def _profile_lanes(members, batch):
    """Where a batch's time goes: one batch of 32 clips tagged by a
    ``StackedEnsemble`` built once (its stacking timed apart) and by the
    members in turn, each on the host clock (after a synchronize, no
    profiler) and under ``torch.profiler``: the device's busy ms (the
    kernels' self time summed), the idle share of the host-clock time and
    the five largest kernels."""
    from pb_sed_tpu_torch.models.base.ensemble import StackedEnsemble
    torch.cuda.synchronize()
    start = time.perf_counter()
    runner = StackedEnsemble(members)
    torch.cuda.synchronize()
    out = {'stack_s': time.perf_counter() - start}
    lanes = {'stacked': lambda: runner.tagging(batch),
             'in_turn': lambda: [m.tagging(batch) for m in members]}
    for lane, fn in lanes.items():
        fn()
        torch.cuda.synchronize()
        collect_garbage()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - start)
        rows = profile_kernels(fn)
        busy = sum(ms for ms, _, _ in rows)
        out[lane] = {'wall_ms': wall, 'busy_ms': busy,
                     'idle': 1. - busy / wall,
                     'top': [(key[:70], ms, n) for ms, key, n in rows[:5]]}
        log(f'profile, tagging one batch of {BATCH} clips by {len(members)} '
            f'members {lane}: {wall:.1f} ms host clock, device busy '
            f'{busy:.1f} ms (idle {out[lane]["idle"]:.0%}); largest '
            f'kernels: ' + '; '.join(f'{k} {ms:.2f} ms x{n}'
                                      for k, ms, n in out[lane]['top']))
    log(f'stacking {len(members)} members (same_architecture, the stacked '
        f'state): {out["stack_s"]:.3f} s')
    return out


def phase_stacked_ensemble(records):
    """Phase 10: the member-axis conv kernels at the shallow tower's
    shapes with 10 members and the deep tower's with 3 (10a), the GRU at
    D = 2N under both designs, then the served lanes (10b). Returns the
    measurements and, under ``launches``, the launch counts of the
    stacked lanes."""
    build.reset_launches()
    check_member_kernels(records, 'shallow', 30, ENSEMBLE_MEMBERS,
                         CONV_LAYERS, [name for name, *_ in CONV_LAYERS[1:]])
    check_member_kernels(records, 'deep', 31, DEEP_MEMBERS, DEEP_CONV_LAYERS,
                         [name for name, *_ in DEEP_CONV_LAYERS[1:]])
    check_member_gru(records)
    log('member-axis conv layers (JSON): ' + json.dumps(MEMBER_ROWS))
    log('gru at D = 2N (JSON): ' + json.dumps(MEMBER_GRU_ROWS))
    with recording_gru_shapes():
        launches, served = phase_ensemble()
    return {'launches': launches, 'served': served,
            'gru': MEMBER_GRU_ROWS}


def phase_ensemble():
    """Phase 10b: 10 full-width shallow FBCRNNs (seeds 0-9) serve phase
    3's 3 x 32 clips through ``models.base``'s tagging, boundaries
    detection and SED 51/1 (stacked in the engine's chunks of
    ``SED_CHUNK`` clips), stacked and in turn; then 3 deep 527-class
    FBCRNNs tag them, plain
    and ``fuse_bn``. Returns the launch counts of the stacked shallow
    runs, of the stacked deep runs, and the measurements."""
    from pb_sed_tpu_torch.models import base
    config = _config('shallow', 10)
    members = _members(config, ENSEMBLE_MEMBERS)
    batches = _synthetic_batches(members[0].module.feature_extractor.stft)
    out, launches = {}, {}
    out['shallow'], launches['ensemble_shallow'] = _lanes(
        members, _methods(base)[:3], batches, 10, 'ensemble shallow',
        {'conv2d_same': len(CONV_LAYERS), 'maxpool_freq2': len(POOLS),
         'gru_scan': 2})
    out['shallow_profile'] = _profile_lanes(members, batches[0])
    del members
    torch.cuda.empty_cache()
    for fuse_bn in (False, True):
        config = _config('deep', 527, fuse_bn=fuse_bn)
        members = _members(config, DEEP_MEMBERS, seed0=20)
        key = 'deep_fuse_bn' if fuse_bn else 'deep'
        expected = ({'conv2d_same': 1, 'bnrelu_conv2d_same': 8} if fuse_bn
                    else {'conv2d_same': len(DEEP_CONV_LAYERS),
                          'maxpool_freq2': len(DEEP_POOLS),
                          'avgpool_freq2': len(DEEP_CROSSINGS)})
        out[key], launches[f'ensemble_{key}'] = _lanes(
            members, _methods(base)[:1], batches, 527, f'ensemble {key}',
            expected)
        del members
        torch.cuda.empty_cache()
    return launches, out


# -- phase 11: the Transformer head, dropout, the profiler, the multi-step
# lane ----------------------------------------------------------------------
# the checkpoints of an 8-step run with steps_per_call = 4 and a checkpoint
# every 3 iterations, where the JAX trainer's lane puts them: its interval
# trigger is polled after each call (iterations 4 and 8) and fires on the
# crossings of 3 and 6; the end of training writes 8 again
LANE_CHECKPOINTS = [4, 8]
TRANSFORMER_FAMILIES = {
    'hand-written kernels': ('conv2d_', 'maxpool_freq2', 'avgpool_freq2',
                             'gru_'),
    'f32 matmuls (attention, feed-forward, in_proj)': ('gemm', 'gemv'),
}


def _transformer_config(augment=True):
    """``fbcrnn_config('shallow')`` with both heads the Transformer head at
    its own defaults (``TransformerEncoder.finalize_dogmatic_config``:
    hidden 256, d_ff 1024, 6 layers, 8 heads, dropout 0.2; the backward
    head its reversed copy), 10 classes."""
    from pb_sed_tpu_torch.models.net_configs import fbcrnn_config
    from pb_sed_tpu_torch.ops.rnn import TransformerEncoder
    config = fbcrnn_config('shallow', num_events=10, augment=augment)
    config['rnn_fwd'] = {'factory': TransformerEncoder}
    return config


def _transformer_model(config, seed, device):
    """The CRNN of ``config`` with ``bridge.init_flat``'s weights (the
    JAX initializers, seeded), on ``device``."""
    from pb_sed_tpu_torch.models import weak_label
    model = weak_label.CRNN.from_config(weak_label.CRNN.get_config(config),
                                        device='cpu')
    model.init_parameters(seed)
    return model.to(device)


def phase_transformer_serving():
    """11a: the Transformer-head FBCRNN at the reference's width serves
    phase 3's 3 x 32 clips by tagging, boundaries and SED 51/1, checked
    like phase 3 and against the same model on the CPU. Returns the
    launch counts of the served run and its clips/s and peak memory."""
    from pb_sed_tpu_torch.models import base
    config = _transformer_config()
    model = _transformer_model(config, 11, 'cuda')
    head = model.module.rnn_fwd
    log(f'Transformer FBCRNN: {model.num_parameters()} parameters; heads '
        f'hidden {head.hidden_size}, d_ff {head.d_ff}, {head.num_layers} '
        f'layers, {head.num_heads} heads, dropout {head.dropout}')
    batches = _synthetic_batches(model.module.feature_extractor.stft)
    methods = _methods(base)[:3]
    stats = {}
    results, launches = _serve(model, methods, batches, 10, 'transformer',
                               kernels=('conv2d_same', 'maxpool_freq2'),
                               stats=stats)
    _agree_with_cpu(_transformer_model(config, 11, 'cpu'), methods, results,
                    batches[1])
    del model
    torch.cuda.empty_cache()
    return launches, stats


def _device_ms_by_family(trace_path, windows):
    """Device ms of the trace's kernels, copies and memsets inside the
    step ``windows`` by family: the port's kernels, the f32 matmuls
    (cuBLAS and its gemv; the Transformer's products), the bf16 matmuls
    (the 1x1 convs, the 1-D tower), the rest (norms, elementwise glue,
    softmax, copies)."""
    from pb_sed_tpu_torch.utils.profiling import device_events, trace_events
    events = trace_events(trace_path)
    by_family = {name: 0. for name in TRANSFORMER_FAMILIES}
    by_family['bf16 matmuls (1x1 convs, 1-D tower)'] = 0.
    by_family['glue (norms, elementwise, softmax, copies)'] = 0.
    names = set()
    for start, end in windows.values():
        for event in device_events(events, start, end):
            name = event['name']
            names.add(name)
            low = name.lower()
            if any(k in name for k in TRANSFORMER_FAMILIES[
                    'hand-written kernels']):
                family = 'hand-written kernels'
            elif any(k in low for k in ('gemm', 'gemv')):
                family = ('bf16 matmuls (1x1 convs, 1-D tower)'
                          if 'bf16' in low or 'bfloat16' in low
                          else 'f32 matmuls (attention, feed-forward, '
                               'in_proj)')
            else:
                family = 'glue (norms, elementwise, softmax, copies)'
            by_family[family] += event['dur'] / 1e3 / len(windows)
    return by_family, names


def phase_transformer_training(tmp):
    """11b: the same model trains 8 steps through ``Trainer`` with its
    heads' dropout 0.2 and the CNN towers' 0.1, augmentation on,
    ``profile_at=3, profile_num_steps=2`` (steps 3-5 traced, the JAX
    trainer's rule). Returns the launch counts and the measurements."""
    from pb_sed_tpu_torch.train.optimizer import Adam
    from pb_sed_tpu_torch.train.trainer import Trainer
    from pb_sed_tpu_torch.utils.profiling import step_times_ms
    config = _transformer_config()
    for tower in ('cnn_2d', 'cnn_1d'):
        config['cnn'][tower]['dropout'] = .1
    model = _transformer_model(config, 11, 'cuda')
    if model.module.cnn.cnn_2d.fused:
        raise AssertionError('a tower with dropout fused a layer')
    stft = model.module.feature_extractor.stft
    batches = _train_batches(stft, 4, BATCH, 10, seed=1, k=10)
    step_log = _StepLog()
    storage = Path(tmp) / 'transformer'
    trainer = Trainer(model, optimizer=Adam(lr=5e-4), storage_dir=storage,
                      summary_trigger=(4, 'iteration'),
                      stop_trigger=(TRAIN_STEPS, 'iteration'),
                      profile_at=3, profile_num_steps=2)
    trainer.register_hook(step_log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    collect_garbage()
    trainer.train(batches * (TRAIN_STEPS // len(batches)))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log(f'launches in the Transformer training run: {launches}')
    for kernel in ('conv2d_same', 'conv2d_same_bwd', 'maxpool_freq2',
                   'maxpool_freq2_bwd'):
        if launches[kernel] <= 0:
            raise AssertionError(f'kernel {kernel} never launched in the '
                                 f'Transformer training run')
    losses = step_log.losses
    log('Transformer loss per step: ' + ', '.join(f'{x:.5f}'
                                                  for x in losses))
    half = len(losses) // 2
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() \
            or not np.mean(losses[half:]) < np.mean(losses[:half]):
        raise AssertionError(f'the Transformer loss did not fall over the '
                             f'second pass over the batches: {losses}')
    traces = sorted((storage / 'profile').glob('trace_*.json'))
    if len(traces) != 1:
        raise AssertionError(f'profile traces: {traces}')
    times = step_times_ms(traces[0])
    from pb_sed_tpu_torch.utils.profiling import step_windows, trace_events
    windows = step_windows(trace_events(traces[0]))
    if sorted(times) != [3, 4, 5]:
        raise AssertionError(f'profiled steps {sorted(times)}, not 3-5')
    by_family, names = _device_ms_by_family(traces[0], windows)
    for what, keys in (('conv forward', ('conv2d_wgmma_kernel',
                                         'conv2d_igemm_kernel')),
                       ('conv backward', ('conv2d_dw_',)),
                       ('max-pool', ('maxpool_freq2',))):
        if not any(k in name for name in names for k in keys):
            raise AssertionError(f'the trace names no {what} kernel of the '
                                 f'port: {sorted(names)[:40]}')
    steps = np.diff(step_log.times)
    log('Transformer step times (host clock, synchronized; steps 3-5 '
        'profiled): ' + ', '.join(f'{1e3 * x:.1f}' for x in steps) + ' ms')
    for step, (host, device) in times.items():
        log(f'Transformer profiled step {step}: host {host:.2f} ms '
            f'(profiler on), device {device:.2f} ms (trace; idle share '
            f'{100 * (1 - device / host):.0f}%)')
    busy = sum(by_family.values())
    log('Transformer step device ms by family (mean of the profiled '
        'steps): ' + ', '.join(f'{name} {ms:.2f}'
                               for name, ms in by_family.items())
        + f'; busy {busy:.2f}')
    # steps 7-8: step 3 holds the profiler's start, step 6 the trace's
    # export and reading
    steady = steps[6:]
    metrics = {
        'steps_per_s': float(1 / steady.mean()),
        'clips_per_s': float(BATCH / steady.mean()),
        'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
        'profiled_steps_ms': {str(k): v for k, v in times.items()},
        'device_ms_by_family': by_family,
        'losses': losses,
    }
    log(f'Transformer training: {metrics["steps_per_s"]:.3f} steps/s = '
        f'{metrics["clips_per_s"]:.1f} clips/s over steps 7-{TRAIN_STEPS} '
        f'(batch {BATCH} x 10 s clips, augmentation and dropout on, host '
        f'clock); peak device memory {metrics["peak_gib"]:.2f} GiB')
    del trainer, model
    torch.cuda.empty_cache()
    return launches, metrics


@contextlib.contextmanager
def recording_masks():
    """The trainer's dropout streams record their masks (yields the list
    of streams)."""
    from pb_sed_tpu_torch.ops.dropout import dropout_rng
    from pb_sed_tpu_torch.train import trainer as trainer_module
    streams = []

    @contextlib.contextmanager
    def recorded(generator):
        with dropout_rng(generator, record=True) as stream:
            streams.append(stream)
            yield stream

    trainer_module.dropout_rng = recorded
    try:
        yield streams
    finally:
        trainer_module.dropout_rng = dropout_rng


def phase_multi_step_lane(tmp):
    """11c: phase 4's shallow GRU FBCRNN with dropout 0.1 in both towers
    and between its 2 GRU layers, from the same weights and seeds, takes 8
    steps as ``steps_per_call=4`` (2 calls) and as 8 single steps, twice
    (the card's own rerun difference; the lane runs between the two, all
    three warm). Returns the launch counts of the lane's run and the
    measurements."""
    from pb_sed_tpu_torch.train.optimizer import Adam
    from pb_sed_tpu_torch.train.trainer import Trainer
    config = _config('shallow', 10)
    for tower in ('cnn_2d', 'cnn_1d'):
        config['cnn'][tower]['dropout'] = .1
    config['rnn_fwd']['rnn']['dropout'] = .1
    flat = _random_flat(config)
    stft = _model(config, flat).module.feature_extractor.stft
    batches = _train_batches(stft, 4, BATCH, 10, seed=5, k=10)
    runs = {}
    for name, k in (('single', 1), ('lane', 4), ('single_again', 1)):
        storage = Path(tmp) / f'lane_{name}'
        trainer = Trainer(_model(config, flat, 'cuda'),
                          optimizer=Adam(lr=5e-4), storage_dir=storage,
                          steps_per_call=k, keep_checkpoints=10,
                          checkpoint_trigger=(3, 'iteration'),
                          stop_trigger=(TRAIN_STEPS, 'iteration'))
        torch.cuda.synchronize()
        if name == 'lane':
            build.reset_launches()
        t0 = time.perf_counter()
        with recording_masks() as streams:
            trainer.train(batches * (TRAIN_STEPS // len(batches)))
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if name == 'lane':
            launches = dict(build.LAUNCHES)
            kept = sum(int(m.sum()) for s in streams for m in s.masks)
            drawn = sum(m.numel() for s in streams for m in s.masks)
        ckpts = sorted(int(p.stem.split('_')[1]) for p in
                       (storage / 'checkpoints').glob('ckpt_[0-9]*.pkl'))
        runs[name] = {'params': {n: p.detach().clone() for n, p in
                                 trainer.model.module.state_dict().items()},
                      'checkpoints': ckpts, 'iteration': trainer.iteration,
                      'seconds': seconds, 'masks': sum(
                          len(s.masks) for s in streams)}
        del trainer, streams
        torch.cuda.empty_cache()
    log(f'launches in the multi-step lane run: {launches}')
    for kernel in ('gru_scan', 'gru_scan_bwd', 'conv2d_same',
                   'conv2d_same_bwd', 'maxpool_freq2'):
        if launches[kernel] <= 0:
            raise AssertionError(f'kernel {kernel} never launched in the '
                                 f'multi-step lane run')

    def gap(a, b):
        return max(float((runs[a]['params'][n].float()
                          - runs[b]['params'][n].float()).abs().max())
                   for n in runs[a]['params'])

    lane_gap, rerun_gap = gap('lane', 'single'), gap('single', 'single_again')
    log(f'multi-step lane vs single steps: max|d| over the state '
        f'{lane_gap:.3e}; single steps rerun on the card {rerun_gap:.3e}')
    if not lane_gap <= 3 * rerun_gap:
        raise AssertionError(f'the lane and the single steps differ by '
                             f'{lane_gap} > 3 x {rerun_gap}')
    log(f'checkpoints: lane {runs["lane"]["checkpoints"]}, single steps '
        f'{runs["single"]["checkpoints"]}')
    if runs['lane']['checkpoints'] != LANE_CHECKPOINTS or runs['single'][
            'checkpoints'] != [3, 6, 8]:
        raise AssertionError('the checkpoint triggers fired elsewhere than '
                             'the JAX trainer\'s lanes fire them')
    rate = kept / drawn
    sigma = np.sqrt(.9 * .1 / drawn)
    log(f'dropout masks of the lane run: {runs["lane"]["masks"]} masks, '
        f'{drawn} draws, keep rate {rate:.6f} (1 - p = 0.9, 4 sigma '
        f'{4 * sigma:.2e})')
    if runs['lane']['masks'] != runs['single']['masks'] or not abs(
            rate - .9) <= 4 * sigma:
        raise AssertionError(f'dropout masks: keep rate {rate}, '
                             f'{runs["lane"]["masks"]} vs '
                             f'{runs["single"]["masks"]} masks')
    metrics = {'lane_gap': lane_gap, 'rerun_gap': rerun_gap,
               'keep_rate': rate, 'draws': drawn,
               'lane_seconds': runs['lane']['seconds'],
               'single_seconds': runs['single']['seconds'],
               'checkpoints': runs['lane']['checkpoints']}
    log(f'multi-step lane: 8 steps in {metrics["lane_seconds"]:.3f} s, '
        f'single steps {metrics["single_seconds"]:.3f} s (host clock, '
        f'checkpoints included)')
    return launches, metrics


def phase_transformer(tmp):
    """Phase 11: 11a-c; returns the launch counts of each path and the
    measurements."""
    out, launches = {}, {}
    start = time.perf_counter()
    launches['transformer_serving'], out['serving'] = \
        phase_transformer_serving()
    launches['transformer_training'], out['training'] = \
        phase_transformer_training(tmp)
    launches['multi_step_lane'], out['lane'] = phase_multi_step_lane(tmp)
    out['seconds'] = time.perf_counter() - start
    log(f'phase 11 took {out["seconds"]:.1f} s')
    return launches, out


# -- phase 12: the data-preparation path, from a raw 44.1 kHz tree ----------
RAW_RATE = 44100
# dataset -> (purpose, directory) of the tree create_json walks
DESED_LAYOUT = {
    'train_weak': ('train', 'weak'), 'train_strong': ('train', 'strong'),
    'train_synthetic20': ('train', 'synthetic20'),
    'train_synthetic21': ('train', 'synthetic21'),
    'validation': ('validation', 'validation'),
    'eval_public': ('eval', 'public'),
    'train_unlabel_in_domain': ('train', 'unlabel_in_domain')}
EXTENSIBLE_CLIP = 'train_strong_4'      # WAVE_FORMAT_EXTENSIBLE: no C++ decode
PREP_ITERATIONS, PREP_RAW_ITERATIONS = 8, 4
PCM_GUID = bytes.fromhex('0100000000001000800000aa00389b71')


def write_wav_file(path, audio, rate, bits=16, extensible=False):
    """PCM ``audio`` (S, C) in [-1, 1] as a RIFF/WAVE file written field
    by field (16- or 24-bit; ``extensible``: format tag
    ``WAVE_FORMAT_EXTENSIBLE`` with the PCM sub-format). Returns the
    bytes written."""
    import struct
    full = 2 ** (bits - 1) - 1
    pcm = np.clip(np.round(audio * full), -full - 1, full).astype('<i4')
    data = pcm.reshape(-1, 1).view(np.uint8)[:, :bits // 8].tobytes()
    channels = audio.shape[1]
    block = channels * bits // 8
    fmt = struct.pack('<HHIIHH', 0xFFFE if extensible else 1, channels,
                      rate, rate * block, block, bits)
    if extensible:
        fmt += struct.pack('<HHI', 22, bits, (1 << channels) - 1) + PCM_GUID
    body = (b'WAVE' + b'fmt ' + struct.pack('<I', len(fmt)) + fmt
            + b'data' + struct.pack('<I', len(data)) + data)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b'RIFF' + struct.pack('<I', len(body)) + body)
    return 8 + len(body)


def write_raw_tree(root, seed):
    """12a: the clips of ``database_clips(seed, 44100)`` (phase 7's sets
    and tone bursts) in DESED's layout under ``root``:
    ``audio/<purpose>/<name>/<clip>.wav`` and the metadata TSVs
    ``metadata/<purpose>/<name>.tsv`` (strong: ``filename onset offset
    event_label``; weak: ``filename event_labels``; none for the unlabeled
    set). 16-bit mono, but every eighth clip stereo (a second channel of
    its own noise), every eighth 24-bit, and ``EXTENSIBLE_CLIP`` with the
    format tag the C++ decoder rejects. Returns ``{dataset: {clip:
    (samples, labels)}}`` and the bytes written."""
    extra = np.random.RandomState(seed + 1)
    expected, nbytes, rows = {}, 0, {}
    for c, (name, i, audio, events, onsets, offsets, _) in enumerate(
            database_clips(seed, RAW_RATE)):
        purpose, directory = DESED_LAYOUT[name]
        clip = f'{name}_{i}'
        audio = audio[:, None]
        if c % 8 == 1:
            audio = np.concatenate(
                [audio, audio + .02 * extra.randn(*audio.shape)], 1)
        nbytes += write_wav_file(
            root / 'audio' / purpose / directory / f'{clip}.wav', audio,
            RAW_RATE, bits=24 if c % 8 == 6 else 16,
            extensible=clip == EXTENSIBLE_CLIP)
        labels = _labels(name, events, onsets, offsets)
        expected.setdefault(name, {})[clip] = (len(audio), labels)
        if name == 'train_weak':
            rows.setdefault(name, []).append(
                f'{clip}.wav\t{",".join(labels["events"])}\n')
        elif labels:
            rows.setdefault(name, []).extend(
                f'{clip}.wav\t{on!r}\t{off!r}\t{ev}\n' for ev, on, off in zip(
                    labels['events'], labels['events_start_times'],
                    labels['events_stop_times']))
    for name, lines in rows.items():
        purpose, directory = DESED_LAYOUT[name]
        header = ('filename\tevent_labels\n' if name == 'train_weak' else
                  'filename\tonset\toffset\tevent_label\n')
        path = root / 'metadata' / purpose / f'{directory}.tsv'
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(header + ''.join(lines))
        nbytes += path.stat().st_size
    return expected, nbytes


def _port_cli(module, *args):
    """``python -m <module> <args>`` from the repository's root; returns
    its output and seconds, raises with its output if it fails."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, '-m', module, *map(str, args)],
                         cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f'{module} {args} failed ({out.returncode}):\n'
                             f'{out.stdout[-3000:]}\n{out.stderr[-3000:]}')
    return out.stdout, seconds


def check_resampled(raw, db16k, expected):
    """12b: one 16 kHz mono int16 wav per raw wav, ``resample_poly``'s
    length, and the metadata copied byte for byte."""
    from math import ceil
    count = 0
    for name, clips in expected.items():
        purpose, directory = DESED_LAYOUT[name]
        for clip, (samples, _) in clips.items():
            path = db16k / 'audio' / purpose / directory / f'{clip}.wav'
            with wave.open(str(path), 'rb') as fid:
                form = (fid.getframerate(), fid.getnchannels(),
                        fid.getsampwidth(), fid.getcomptype())
                frames = fid.getnframes()
            if form != (16000, 1, 2, 'NONE') \
                    or frames != ceil(samples * 160 / 441):
                raise AssertionError(f'{path}: {form}, {frames} frames')
            count += 1
    if count != len(list(db16k.rglob('*.wav'))):
        raise AssertionError('resample_db wrote other wav files')
    tsvs = sorted(p.relative_to(raw) for p in raw.rglob('*.tsv'))
    if tsvs != sorted(p.relative_to(db16k) for p in db16k.rglob('*.tsv')) \
            or any((raw / t).read_bytes() != (db16k / t).read_bytes()
                   for t in tsvs):
        raise AssertionError('the metadata was not copied as it was')
    return count


def check_database_json(json_path, root, expected, rate):
    """12c: every set and clip written, with its events, onsets and
    offsets; each ``audio_length`` within one sample (at ``rate``) of the
    length written."""
    from pb_sed_tpu_torch.utils.misc import load_json
    datasets = load_json(json_path)['datasets']
    if sorted(datasets) != sorted(expected):
        raise AssertionError(f'{json_path}: sets {sorted(datasets)}')
    worst = 0.
    for name, clips in expected.items():
        if sorted(datasets[name]) != sorted(clips):
            raise AssertionError(f'{json_path}: clips of {name}')
        purpose, directory = DESED_LAYOUT[name]
        for clip, (samples, labels) in clips.items():
            example = datasets[name][clip]
            path = root / 'audio' / purpose / directory / f'{clip}.wav'
            error = abs(example['audio_length'] - samples / RAW_RATE)
            worst = max(worst, error)
            got = {key: example[key] for key in example
                   if key not in ('audio_path', 'audio_length')}
            if got != labels or example['audio_path'] != str(path) \
                    or not error <= 1. / rate:
                raise AssertionError(f'{json_path}: {name}/{clip}: '
                                     f'{example} vs {labels}, {samples}')
    return worst


@contextlib.contextmanager
def recording_native_reads():
    """``data.native.load_wav`` wrapped to record, per call, the file and
    the samples it returned (None: rejected)."""
    from pb_sed_tpu_torch.data import native
    calls, load_wav = [], native.load_wav

    def recording(path, *args, **kwargs):
        out = load_wav(path, *args, **kwargs)
        calls.append((str(path), None if out is None else out.shape[-1]))
        return out

    native.load_wav = recording
    try:
        yield calls
    finally:
        native.load_wav = load_wav


def _prep_training(json_path, run_dir, iterations):
    """12d: the weak training CLI on ``json_path`` for ``iterations`` at the
    shallow recipe's full width with its loader (batch 32, two prefetch
    workers, augmentation, the default ``AudioReader``), no validation.
    Returns its launches, losses, steps/s over iterations 3 to the last,
    wall seconds and the C++ reader's calls."""
    from pb_sed_tpu_torch.experiments.weak_label_crnn.training import ex
    from pb_sed_tpu_torch.utils.misc import load_json
    updates = _cli_updates(
        json_path, run_dir, lr_rampup_steps=4, num_iterations=iterations,
        checkpoint_interval=iterations,
        data_provider={'json_path': str(json_path), 'validate_set': None})
    torch.cuda.synchronize()
    build.reset_launches()
    collect_garbage()
    with timed_trainer() as record, recording_native_reads() as reads:
        t0 = time.perf_counter()
        ex.run(config_updates=updates)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    config = load_json(run_dir / '1' / 'config.json')
    check_recipe(config)
    reader = config['data_provider']['audio_reader']
    steps = record['steps']
    losses = [loss for *_, loss in steps]
    log(f'{json_path.parent.name}: launches {launches}; loss per step '
        + ', '.join(f'{x:.5f}' for x in losses))
    for kernel in SHALLOW:
        if launches[kernel] <= 0:
            raise AssertionError(f'kernel {kernel} never launched in the '
                                 f'training run on {json_path}')
    if [it for it, *_ in steps] != list(range(1, iterations + 1)) \
            or not np.isfinite(losses).all() \
            or record['validate'] or record['test_run'] \
            or reader['use_native'] is not True \
            or reader['source_sample_rate'] is not None:
        raise AssertionError(f'the training run on {json_path}: {steps}, '
                             f'{record}, {reader}')
    span = steps[-1][2] - steps[1][2]
    return {'launches': launches, 'losses': losses,
            'steps_per_s': (iterations - 2) / span, 'wall_s': wall,
            'reads': reads}


def _loader_ms(json_path, storage_dir, use_native):
    """Host ms a batch of the recipe's train loader over one epoch (the
    first batch left out), reading with ``use_native``; ``storage_dir`` is
    a training run's, whose labels the encoder restores."""
    from pb_sed_tpu_torch.data.provider import DataProvider
    from pb_sed_tpu_torch.experiments.weak_label_crnn.training import ex
    reader = {'json_path': str(json_path),
              'audio_reader': {'use_native': use_native}}
    config = ex.build_config(_cli_updates(
        json_path, storage_dir, data_provider=reader))['data_provider']
    provider = DataProvider.from_config(config)
    provider.train_transform.label_encoder.initialize_labels()
    if provider.audio_reader.use_native is not use_native:
        raise AssertionError('the loader took another reader')
    it = iter(provider.get_train_set())
    next(it)
    collect_garbage()
    t0 = time.perf_counter()
    n = sum(1 for _ in it)              # to the epoch's end: threads end
    return 1e3 * (time.perf_counter() - t0) / n, n


def check_reader(raw, db16k, json16k, storage_dir, expected):
    """12e on the card's host: ``load_wav_batch`` equals ``load_wav`` file by
    file in every bit; on the 16 kHz files the C++ path lies within 1.2e-7
    of ``read_wav``'s (``use_native=False``); the gap to ``resample_poly``
    at 44.1 kHz and the ms a clip of both paths are printed, as are the
    loader's ms a batch with ``use_native`` True and False, in pairs
    (A B B A)."""
    from pb_sed_tpu_torch.data import native
    from pb_sed_tpu_torch.data.audio import AudioReader
    every = [f'audio/{"/".join(DESED_LAYOUT[name])}/{clip}.wav'
             for name, clips in expected.items() for clip in clips]
    # the first eight hold a stereo and a 24-bit clip
    raw_files = [raw / f for f in every[:8]] + [
        raw / f'audio/train/strong/{EXTENSIBLE_CLIP}.wav']
    out = {}
    for label, paths in (('raw', raw_files),
                         ('db16k', [db16k / f for f in every[:8]])):
        batch = native.load_wav_batch(paths)
        for path, got in zip(paths, batch):
            single = native.load_wav(path)
            if (got is None) != (single is None) or (
                    got is not None and not np.array_equal(got, single)):
                raise AssertionError(f'load_wav_batch differs at {path}')
        out[f'batch_rejected_{label}'] = [
            p.name for p, b in zip(paths, batch) if b is None]
    if out['batch_rejected_raw'] != [f'{EXTENSIBLE_CLIP}.wav'] \
            or out['batch_rejected_db16k']:
        raise AssertionError(f'files the decoder rejected: {out}')
    worst = 0.
    for f in every:
        example = {'audio_path': str(db16k / f)}
        got = AudioReader()(dict(example))['audio_data']
        ref = AudioReader(use_native=False)(dict(example))['audio_data']
        worst = max(worst, float(np.abs(got - ref).max()))
    out['max_abs_16k_native_vs_read_wav'] = worst
    if not worst <= 1.2e-7:
        raise AssertionError(f'16 kHz: C++ vs read_wav {worst:.3e}')
    reads, ms = {}, {True: [], False: []}
    for use_native in (True, False, False, True):
        collect_garbage()
        t0 = time.perf_counter()
        reads[use_native] = [AudioReader(use_native=use_native)(
            {'audio_path': str(p)})['audio_data'] for p in raw_files]
        ms[use_native].append(
            1e3 * (time.perf_counter() - t0) / len(raw_files))
    pairs = list(zip(reads[True], reads[False]))
    # over the shorter: the sinc gives floor(S * 160 / 441) samples,
    # resample_poly the ceiling
    gap = max(float(np.abs(a[:, :b.shape[1]] - b[:, :a.shape[1]]).max())
              for a, b in pairs)
    lengths = sorted({b.shape[1] - a.shape[1] for a, b in pairs})
    out['max_abs_44k_native_vs_resample_poly'] = gap
    out['samples_44k_resample_poly_minus_native'] = lengths
    out['ms_a_44k_clip'] = {'native': ms[True], 'resample_poly': ms[False]}
    loader = {True: [], False: []}
    for use_native in (True, False, False, True):
        batch_ms, batches = _loader_ms(json16k, storage_dir, use_native)
        loader[use_native].append(batch_ms)
    out['loader_ms_a_batch'] = {'native': loader[True],
                                'read_wav': loader[False],
                                'batches': batches}
    log(f'12e reader: load_wav_batch == load_wav in every bit on '
        f'{len(raw_files)} raw and 8 db16k files (rejected: '
        f'{out["batch_rejected_raw"]}); 16 kHz C++ vs read_wav max|d| '
        f'{worst:.3e} (tol 1.2e-7) over {len(every)} files; 44.1 kHz C++ '
        f'vs resample_poly max|d| {gap:.4f} (the JAX reader\'s '
        f'semantics, no gate; resample_poly longer by {lengths} '
        f'samples); ms a 44.1 kHz clip (host clock, A B B A): '
        f'C++ {ms[True]}, read_wav + resample_poly {ms[False]}; loader ms '
        f'a batch at 16 kHz (A B B A, {batches} batches each): C++ '
        f'{loader[True]}, read_wav {loader[False]}')
    return out


def phase_data_prep(tmp, card, cli_metrics):
    """Phase 12: a raw DESED-layout tree at 44.1 kHz -> ``resample_db`` ->
    ``create_json`` -> the weak training CLI on the card, reading through
    the C++ reader. ``cli_metrics`` is phase 7's, printed beside this
    phase's steps/s. Returns the launch counts of the two training runs
    and the measurements."""
    out, seconds = {}, {}
    start = t0 = time.perf_counter()
    raw, db16k = tmp / 'raw', tmp / 'db16k'
    expected, nbytes = write_raw_tree(raw, seed=12)
    seconds['12a'] = time.perf_counter() - t0
    clips = sum(len(c) for c in expected.values())
    log(f'12a: raw tree of {clips} clips at {RAW_RATE} Hz (stereo, 24-bit '
        f'and one WAVE_FORMAT_EXTENSIBLE among them), {nbytes} bytes '
        f'({nbytes / 2 ** 20:.1f} MiB) in {seconds["12a"]:.1f} s')

    t0 = time.perf_counter()
    text, first_s = _port_cli('pb_sed_tpu_torch.database.resample_db',
                              '-i', raw, '-o', db16k, '-n', 8)
    count = check_resampled(raw, db16k, expected)
    stamps = {p: p.stat().st_mtime_ns for p in db16k.rglob('*')}
    again, again_s = _port_cli('pb_sed_tpu_torch.database.resample_db',
                               '-i', raw, '-o', db16k, '-n', 8)
    if '0 files to process' not in again or stamps != {
            p: p.stat().st_mtime_ns for p in db16k.rglob('*')}:
        raise AssertionError(f'the second resample_db run: {again}')
    seconds['12b'] = time.perf_counter() - t0
    log(f'12b: resample_db wrote {count} 16 kHz mono int16 files and the '
        f'metadata in {first_s:.1f} s ({text.splitlines()[0]}); a second '
        f'run skipped every file in {again_s:.1f} s')

    t0 = time.perf_counter()
    jsons, lengths = {}, {}
    for label, root, rate in (('db16k', db16k, 16000),
                              ('raw', raw, RAW_RATE)):
        _, cli_s = _port_cli('pb_sed_tpu_torch.database.desed.create_json',
                             '-db', root, '-j', tmp / f'jsons_{label}')
        jsons[label] = tmp / f'jsons_{label}' / 'desed.json'
        lengths[label] = check_database_json(jsons[label], root, expected,
                                             rate)
        log(f'12c: create_json on {label}: {cli_s:.1f} s, every set and '
            f'clip with its labels, audio_length off by at most '
            f'{lengths[label]:.2e} s (one sample: {1 / rate:.2e})')
    seconds['12c'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    runs = {'db16k': _prep_training(jsons['db16k'], tmp / 'exp' / 'db16k',
                                    PREP_ITERATIONS)}
    seconds['12d'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out['reader'] = check_reader(raw, db16k, jsons['db16k'],
                                 tmp / 'exp' / 'db16k', expected)
    seconds['12e'] = time.perf_counter() - t0
    # after 12e: this run's prefetch threads outlive it, decoding ahead
    t0 = time.perf_counter()
    runs['raw'] = _prep_training(jsons['raw'], tmp / 'exp' / 'raw',
                                 PREP_RAW_ITERATIONS)
    seconds['12d'] += time.perf_counter() - t0
    reads = runs['raw']['reads']
    decoded = [n for path, n in reads if n is not None]
    rejected = {Path(path).stem for path, n in reads if n is None}
    if not decoded or not rejected <= {EXTENSIBLE_CLIP} or not all(
            path.startswith(str(raw)) for path, _ in reads):
        raise AssertionError(f'the raw run\'s reads: {reads[:8]}')
    for label, run in runs.items():
        reads = run.pop('reads')
        run['native_reads'] = len(reads)
    log(f'12d: the C++ reader resampled {len(decoded)} reads of 44.1 kHz '
        f'files in the raw run (rejected, read by read_wav: '
        f'{sorted(rejected)})')
    out.update(runs=runs, seconds=seconds, card=card,
               total_s=time.perf_counter() - start)
    log(f'12d: training from db16k {runs["db16k"]["steps_per_s"]:.3f} '
        f'steps/s over iterations 3-{PREP_ITERATIONS}, from raw 44.1 kHz '
        f'{runs["raw"]["steps_per_s"]:.3f} over 3-{PREP_RAW_ITERATIONS}, '
        f'beside phase 7\'s {cli_metrics["steps_per_s"]:.3f} '
        f'(validation out); seconds ' + ', '.join(
            f'{k} {v:.1f}' for k, v in seconds.items())
        + f'; phase 12 took {out["total_s"]:.1f} s ({card})')
    return {f'data_prep_training{"" if label == "db16k" else "_raw"}':
            run['launches'] for label, run in runs.items()}, out


# -- phase 13: the mesh on torch.distributed ----------------------------------
MESH_WORLD = 2
MESH_STEPS = 4
MESH_TIMEOUT_S = 300.
# the tuning chain's score shapes (a tuning batch of 16 clips, 10 classes,
# 500 frames) and filter lengths from its grids
FILTER_SHAPE = (16, 10, FRAMES)
FILTER_CASES = [('medfilt', 21), ('medfilt', 41), ('meanfilt', 20),
                ('meanfilt', 21), ('maxfilt', 21), ('stepfilt', 20),
                ('boundariesfilt', 20), ('boundariesfilt', 0)]


def _mesh_data():
    """Phase 13's inputs, made from seeds in every process that needs
    them: the shallow recipe's config and weights (seed 0), 4 training
    batches of 32 ten-second clips and phase 3's 3 x 32 clips."""
    config = _config('shallow', 10)
    flat = _random_flat(config)
    stft = _model(config, flat).module.feature_extractor.stft
    return (config, flat, _train_batches(stft, MESH_STEPS, BATCH, 10, seed=5),
            _synthetic_batches(stft))


def _mesh_rows(batch, rank, world):
    """Rank ``rank``'s contiguous share of ``batch``: its rows of the
    global batch, as the fetcher's batch-level shards give them."""
    n = len(batch['seq_len']) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


class _RoundingProbe:
    """One process's own rounding noise, as a stand-in for the trainer's
    ``DataShard``: the one process's rows and draws, each element of
    every global sum moved by one f32 ulp (2^-23 relative) up or down at
    random (the signs from ``gen``), the size of the rounding by which a
    mesh's split sums differ from one process's (:func:`_ulp_moved` moves
    the gradients so too, as the mesh's gradient all-reduce rounds them).
    The steps it gives differ from one process's by what the
    training-mode norms' bf16 roundings make of such roundings."""

    def __init__(self, rows, gen):
        self.offset, self.rows, self.total = 0, rows, rows
        self.gen = gen

    def sum(self, *xs):
        out = tuple(_ulp_moved(x, self.gen) for x in xs)
        return out[0] if len(xs) == 1 else out

    def gather(self, x):
        return x

    def local(self, x):
        return x


# the probes of 13a's noise rule: one probe's noise for a quantity scatters
# over its signs' seed (norm_1.scale's update 0.058-0.278 over seeds 0-4,
# one code and one card), so the rule takes the mean over several
MESH_PROBES = 5


def _ulp_moved(x, gen):
    """``x`` with each element moved by one f32 ulp, up or down, the
    signs drawn from ``gen``."""
    signs = torch.randint(0, 2, x.shape, generator=gen, device=x.device)
    return x * (1 + 2 ** -23 * (2. * signs - 1.))


def _mesh_training(config, flat, batches, rank=None, world=1, probe=None):
    """``len(batches)`` steps of the full-width shallow FBCRNN on the card
    (augmentation on, the shallow recipe's Adam with a ramp), in one
    process (with a ``probe`` seed, its sums moved by
    :class:`_RoundingProbe`, the signs drawn from that seed),
    or with ``rank`` on its rows of each batch through the trainer's mesh
    (``use_mesh``, the default). Returns the losses, the synchronized
    host seconds of each step, the launches of the run and the final flat
    state."""
    from pb_sed_tpu_torch import bridge
    from pb_sed_tpu_torch.train.hooks import LRAnnealingHook
    from pb_sed_tpu_torch.train.optimizer import Adam
    from pb_sed_tpu_torch.train.trainer import Trainer
    model = _model(config, flat, device='cuda')
    trainer = Trainer(model, optimizer=Adam(**RECIPES['shallow']['adam']),
                      stop_trigger=(MESH_STEPS, 'iteration'))
    trainer.register_hook(LRAnnealingHook(
        breakpoints=[(0, .1), (MESH_STEPS, 1.)]))
    if (trainer.mesh is None) != (rank is None):
        raise AssertionError(f'rank {rank}: the trainer\'s mesh is '
                             f'{trainer.mesh}')
    if probe is not None:
        gen = torch.Generator(device='cuda').manual_seed(probe)
        trainer._shard = lambda batch: (batch, _RoundingProbe(
            len(batch['seq_len']), gen))
        trainer._reduce_gradients = lambda grads: [_ulp_moved(g, gen)
                                                   for g in grads]
    torch.cuda.synchronize()
    build.reset_launches()
    losses, seconds = [], []
    for batch in batches:
        if rank is not None:
            batch = _mesh_rows(batch, rank, world)
        start = time.perf_counter()
        losses.append(float(trainer.train_step(batch)))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
    launches = dict(build.LAUNCHES)
    for kernel in SHALLOW:
        if launches[kernel] <= 0:
            raise AssertionError(f'rank {rank}: {kernel} never launched in '
                                 f'the mesh training run')
    return {'losses': losses, 'seconds': seconds, 'launches': launches,
            'state': bridge.export_flat(model.module)}


def mesh_rank(rank, world):
    """One rank of phase 13's gloo world on the one card: 13a's training
    steps on its rows, then 13c's 10-member stacked ensemble over the
    ranks (its share of the members, the whole scores back)."""
    from pb_sed_tpu_torch.models.base.ensemble import StackedEnsemble
    from pb_sed_tpu_torch.parallel.mesh import default_ensemble_mesh
    torch.set_num_threads(max(1, os.cpu_count() // world))   # host cores
    build.lib()
    config, flat, batches, clips = _mesh_data()
    out = {'training': _mesh_training(config, flat, batches, rank, world)}
    torch.cuda.empty_cache()
    mesh = default_ensemble_mesh(ENSEMBLE_MEMBERS)
    runner = StackedEnsemble(_members(config, ENSEMBLE_MEMBERS), mesh=mesh)
    build.reset_launches()
    start = time.perf_counter()
    tags = [runner.tagging(b)[0] for b in clips[:2]]
    sed = runner.sound_event_detection(clips[2], window_length=51,
                                       window_shift=1)[0]
    torch.cuda.synchronize()
    out['ensemble'] = {
        'axes': list(mesh.axis_names), 'grid': mesh.grid.tolist(),
        'members_here': len(runner.local_members),
        'tags': tags, 'sed': sed, 'seconds': time.perf_counter() - start,
        'launches': dict(build.LAUNCHES)}
    out['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def nccl_rank(rank, world):
    """13b: one rank of a world formed by ``initialize_distributed`` under
    torchrun's variables with its default backend on the card (NCCL):
    ``Trainer(use_mesh=True)`` takes 2 steps, so every collective of the
    step goes through NCCL."""
    import torch.distributed as dist
    build.lib()
    config, flat, batches, _ = _mesh_data()
    out = _mesh_training(config, flat, batches[:2], rank, world)
    out['backend'] = dist.get_backend()
    return out


def _check_mesh_steps(got, ref, probes, module, label):
    """The mesh's steps (``got``) against one process's (``ref``) by the
    looser of two rules, per quantity: the CPU test's tolerance
    (``tests/test_torch_mesh.py``: losses within 1e-3 * |ref|, each
    parameter's update over the steps at 1 - cos <= 0.02, running
    statistics within 1e-4 + 1e-2 * max|ref|) and ``_card_vs_cpu``'s
    noise rule, three times the one process's own noise: the mean over
    ``probes`` (its steps with every global sum moved by one ulp,
    ``_RoundingProbe``, at ``MESH_PROBES`` seeds of the signs) of each
    probe's deviation from one process's.
    At full width the tower's bf16 roundings through the training-mode
    norms turn the mesh's split sums into update cosines down to 0.83
    after 4 steps (my first card run), where the tiny CPU models keep
    them above 0.98. As in ``_card_vs_cpu``, the norm-fed biases (an
    identically zero gradient) and tensors of fewer than 16 entries (the
    entry norm's two scalars) are printed, not held. Returns the worst
    deviation over its bound of each, and which rule bound it."""
    p0 = ref['p0']
    bn_fed = {f'params.{name}' for name in bn_fed_biases(module)}
    worst, rows, failed = {}, [], []

    def hold(kind, key, dev, stated, noise):
        bound = max(stated, 3 * noise)
        rule = 'stated' if stated >= 3 * noise else '3x noise'
        rows.append((kind, str(key), dev, noise, bound, rule))
        if kind not in worst or dev / bound > worst[kind][0]:
            worst[kind] = (dev / bound, key, dev, bound, rule)
        if not dev <= bound:
            failed.append(rows[-1])

    for step, (a, r) in enumerate(zip(got['losses'], ref['losses'])):
        hold('loss', step + 1, abs(a - r), 1e-3 * abs(r),
             float(np.mean([abs(p['losses'][step] - r) for p in probes])))
    for key, value in ref['state'].items():
        if key.startswith('params.'):
            upd = torch.from_numpy(value - p0[key])

            def gap(state):
                return 1 - _cosine(torch.from_numpy(state[key] - p0[key]),
                                   upd)

            dev = gap(got['state'])
            noise = float(np.mean([gap(p['state']) for p in probes]))
            if key in bn_fed or value.size < 16:
                log(f'  {key}: update 1 - cos {dev:.4f}, one process\'s '
                    f'noise {noise:.4f} (printed only)')
                continue
            hold('update', key, dev, .02, noise)
        elif not key.endswith('initialized'):
            hold('statistic', key, float(np.abs(got['state'][key] - value)
                                         .max()),
                 1e-4 + 1e-2 * float(np.abs(value).max()),
                 float(np.mean([np.abs(p['state'][key] - value).max()
                                for p in probes])))
    log(f'{label}, every held quantity (kind, key, deviation, one '
        f'process\'s noise, bound, rule; JSON): ' + json.dumps(rows))
    log(f'{label} vs one process: losses {got["losses"]} vs {ref["losses"]}'
        f' (the probes {[p["losses"] for p in probes]}); worst of each, '
        f'deviation / bound'
        f' (key, deviation, bound, rule): ' + '; '.join(
            f'{kind} {w[0]:.3f} ({w[1]}, {w[2]:.3e}, {w[3]:.3e}, {w[4]})'
            for kind, w in worst.items()))
    if failed:
        raise AssertionError(f'{label}: {len(failed)} quantities outside '
                             f'their bound: {failed}')
    return {kind: {'over_bound': w[0], 'key': str(w[1]), 'deviation': w[2],
                   'bound': w[3], 'rule': w[4]}
            for kind, w in worst.items()}


def _event_scalars(storage_dir):
    """{(tag, step): value} of the scalar events in ``storage_dir``'s event
    files, read with tensorboardX's protobuf classes (TFRecord framing:
    length, its CRC, the Event, its CRC)."""
    import struct
    from tensorboardX.proto import event_pb2
    out = {}
    for path in Path(storage_dir).glob('events.out.tfevents.*'):
        data = path.read_bytes()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack('<Q', data[pos:pos + 8])
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for value in event.summary.value:
                if value.HasField('simple_value'):
                    out[(value.tag, event.step)] = value.simple_value
    return out


def _trace_and_summaries(config, flat, batches):
    """13d, and 13e's tensorboard check: 3 one-process steps, the last two
    profiled, with a summary every step."""
    import importlib.util
    from pb_sed_tpu_torch.train.optimizer import Adam
    from pb_sed_tpu_torch.train.trainer import Trainer
    from pb_sed_tpu_torch.utils import trace
    from pb_sed_tpu_torch.utils.profiling import step_times_ms
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(_model(config, flat, device='cuda'),
                          optimizer=Adam(**RECIPES['shallow']['adam']),
                          storage_dir=tmp, summary_trigger=(1, 'iteration'),
                          checkpoint_trigger=(100, 'iteration'),
                          stop_trigger=(3, 'iteration'), profile_at=2,
                          profile_num_steps=2)
        trainer.train(batches[:3])
        (path,) = Path(tmp, 'profile').glob('trace_*.json')
        events = trace.trace_events(path)
        summed = step_times_ms(path)
        union = trace.device_step_times_ms(events)
        for step, device in union.items():
            host, total = summed[step]
            log(f'13d: profiled step {step}: host {host:.2f} ms, device '
                f'{device:.2f} ms (union of intervals) vs {total:.2f} ms '
                f'(summed durations)')
            if not abs(device - total) <= .01 * total or device <= 0:
                raise AssertionError(f'step {step}: device_step_times_ms '
                                     f'{device} vs step_times_ms {total}')
        out['steps'] = {s: {'host_ms': summed[s][0], 'device_ms': d}
                        for s, d in union.items()}
        out['top_ops'] = trace.op_breakdown_ms(events, top=10)
        out['stalls'] = trace.stall_gaps_ms(events, top=5)
        out['duty_cycle'] = trace.duty_cycle_summary(events)
        log('13d: top 10 ops of the profiled steps (device ms, count): '
            + '; '.join(f'{k} {ms:.3f} x{n}'
                        for k, (ms, n) in out['top_ops'].items()))
        stalls = out['stalls']
        log(f'13d: idle gaps of the longest step: span {stalls["span_ms"]} '
            f'ms, busy {stalls["busy_ms"]} ms, {stalls["n_gaps"]} gaps of '
            f'>= 0.1 ms, {stalls["gap_ms"]} ms; the 5 longest (ms, at ms, '
            f'host op): ' + '; '.join(f'{g} at {at} behind {op}'
                                      for g, at, op in stalls['gaps']))
        log(f'13d: duty cycle {out["duty_cycle"]}')
        tensorboard = importlib.util.find_spec('tensorboardX') is not None
        out['tensorboardX'] = tensorboard
        log(f'13e: tensorboardX importable: {tensorboard}'
            + ('' if tensorboard else ' (summary.jsonl alone)'))
        if tensorboard:
            events = _event_scalars(tmp)
            with open(f'{tmp}/summary.jsonl') as fid:
                lines = [json.loads(line) for line in fid]
            checked = 0
            for line in lines:
                for key, value in line.items():
                    if key in ('iteration', 'prefix', 'time'):
                        continue
                    got = events[(f'{line["prefix"]}/{key}',
                                  line['iteration'])]
                    if not np.isclose(got, value, rtol=1e-6, atol=1e-12):
                        raise AssertionError(f'event {key} {got} vs '
                                             f'summary.jsonl {value}')
                    checked += 1
            log(f'13e: {checked} event-file scalars equal summary.jsonl\'s')
            out['event_scalars_checked'] = checked
    return out


def _check_filters():
    """13e: the tensor filters on CUDA tensors against the numpy filters
    at the tuning chain's score shapes (f32 against f64: within 1e-6 *
    max|ref|); ms of both (CUDA events; the host clock for numpy)."""
    from pb_sed_tpu_torch.ops import filters
    scores = np.random.RandomState(9).rand(*FILTER_SHAPE).astype(np.float32)
    x = torch.from_numpy(scores).cuda()
    rows = []
    for name, n in FILTER_CASES:
        tensor_fn = getattr(filters, f'{name}_torch')
        got = tensor_fn(x, n).cpu().numpy()
        start = time.perf_counter()
        ref = getattr(filters, name)(scores.astype(np.float64), n)
        numpy_ms = 1e3 * (time.perf_counter() - start)
        err = float(np.abs(got - ref).max())
        tol = 1e-6 * float(np.abs(ref).max())
        row = {'filter': name, 'n': n, 'max_abs_err': err,
               'ms': cuda_ms(lambda: tensor_fn(x, n)), 'numpy_ms': numpy_ms}
        rows.append(row)
        if not err <= tol or got.shape != ref.shape:
            raise AssertionError(f'{name}({n}) on the card: {err} > {tol}')
    log(f'13e: device filters at {FILTER_SHAPE} vs numpy (JSON): '
        + json.dumps(rows))
    return rows


def phase_mesh(card):
    """Phase 13: the mesh. 13a: a world of MESH_WORLD ranks on the one card
    (gloo, both on cuda:0) trains the full-width shallow FBCRNN for
    MESH_STEPS steps on 4 global batches of 32 ten-second clips (16 a
    rank; augmentation on; weights from seed 0), held against one process
    taking the same steps on the same clips by the looser of the CPU
    test's tolerance and three times the one process's own rounding
    noise (``_check_mesh_steps``; both ranks must end in the same state
    in every bit), each rank's shallow kernels launching. 13b: a
    1-rank world formed by ``initialize_distributed`` with its default
    backend (NCCL) trains 2 steps. 13c: the 10 shallow members of phase
    10 over the 2-rank world (an ensemble axis of 2, five members a rank)
    tag 2 batches of 32 and run SED 51/1 on one, against one process's
    stacked ensemble within phase 10's tolerance (1e-4 + 3e-2 *
    max|ref|). 13d: the trace reader on profiled shallow steps. 13e: the
    device filters, and the tensorboard rule. Returns the launch counts
    and the measurements."""
    from pb_sed_tpu_torch.models.base.ensemble import StackedEnsemble
    from pb_sed_tpu_torch.parallel.launch import run_ranks
    phase_start = time.perf_counter()
    torch.cuda.empty_cache()
    config, flat, batches, clips = _mesh_data()
    ref = _mesh_training(config, flat, batches)
    ref['p0'] = flat
    probes = [_mesh_training(config, flat, batches, probe=seed)
              for seed in range(MESH_PROBES)]
    start = time.perf_counter()
    ranks = run_ranks(mesh_rank, MESH_WORLD, backend='gloo',
                      timeout_s=MESH_TIMEOUT_S)
    world_s = time.perf_counter() - start
    out = {'card': card, 'world_s': world_s}
    launches = {}
    module = _model(config, flat).module
    for rank, result in enumerate(ranks):
        launches[f'mesh_training_rank{rank}'] = result['training']['launches']
        launches[f'mesh_ensemble_rank{rank}'] = result['ensemble']['launches']
        for kernel in FORWARD:
            if result['ensemble']['launches'][kernel] <= 0:
                raise AssertionError(f'rank {rank}: {kernel} never launched '
                                     f'in the ensemble over the ranks')
        for key, value in ranks[0]['training']['state'].items():
            if not np.array_equal(result['training']['state'][key], value):
                raise AssertionError(f'rank {rank} ends with another {key} '
                                     f'than rank 0')
    out['training'] = _check_mesh_steps(ranks[0]['training'], ref, probes,
                                        module,
                                        f'13a: {MESH_WORLD} ranks (gloo)')

    def steady(seconds):
        return 1. / float(np.mean(seconds[1:]))   # step 1: warm-up

    out['steps_per_s'] = {'one_process': steady(ref['seconds']),
                          **{f'rank{r}': steady(x['training']['seconds'])
                             for r, x in enumerate(ranks)}}
    log(f'13a: steps/s over steps 2-{MESH_STEPS} (host clock, '
        f'synchronized): one process {out["steps_per_s"]["one_process"]:.3f}'
        f' at batch {BATCH}; {MESH_WORLD} gloo ranks sharing ONE card, '
        f'{BATCH // MESH_WORLD} clips a rank: ' + ', '.join(
            f'rank {r} {out["steps_per_s"][f"rank{r}"]:.3f}'
            for r in range(MESH_WORLD))
        + ' (a shared card, not a scaling number); peak device memory a '
        'rank ' + ', '.join(f'{x["peak_gib"]:.2f}' for x in ranks)
        + f' GiB; the world took {world_s:.1f} s with its processes\' start')

    start = time.perf_counter()
    (nccl,) = run_ranks(nccl_rank, 1, backend=None,
                        timeout_s=MESH_TIMEOUT_S)
    launches['mesh_nccl_training'] = nccl['launches']
    dev = float(np.max(np.abs(np.asarray(nccl['losses'])
                              - ref['losses'][:2])
                       / np.abs(ref['losses'][:2])))
    log(f'13b: a 1-rank world on {nccl["backend"]} (initialize_distributed '
        f'under torchrun\'s variables): losses {nccl["losses"]} vs one '
        f'process {ref["losses"][:2]} (max rel dev {dev:.2e}, bound 1e-3), '
        f'{time.perf_counter() - start:.1f} s with its process\'s start')
    if nccl['backend'] != 'nccl' or not dev <= 1e-3:
        raise AssertionError(f'13b: {nccl["backend"]}, {nccl["losses"]}')
    out['nccl'] = {'backend': nccl['backend'], 'losses': nccl['losses'],
                   'loss_rel_dev': dev}

    members = _members(config, ENSEMBLE_MEMBERS)
    local = StackedEnsemble(members)
    expected = {'tagging': [local.tagging(b)[0] for b in clips[:2]],
                'sed': local.sound_event_detection(
                    clips[2], window_length=51, window_shift=1)[0]}
    del local, members
    torch.cuda.empty_cache()
    worst = 0.
    for rank, result in enumerate(ranks):
        ens = result['ensemble']
        if ens['axes'] != ['ensemble', 'data'] or ens['members_here'] != \
                ENSEMBLE_MEMBERS // MESH_WORLD:
            raise AssertionError(f'rank {rank}: {ens["axes"]}, '
                                 f'{ens["members_here"]} members')
        for got, want in zip(ens['tags'] + [ens['sed']],
                             expected['tagging'] + [expected['sed']]):
            err = float(np.abs(got - want).max())
            tol = 1e-4 + 3e-2 * float(np.abs(want).max())
            worst = max(worst, err / tol)
            if got.shape != want.shape or not err <= tol:
                raise AssertionError(f'13c rank {rank}: {got.shape} vs '
                                     f'{want.shape}, {err} > {tol}')
    out['ensemble'] = {'worst_dev_over_tol': worst,
                       'seconds': [x['ensemble']['seconds'] for x in ranks]}
    log(f'13c: {ENSEMBLE_MEMBERS} members over {MESH_WORLD} ranks '
        f'(grid {ranks[0]["ensemble"]["grid"]}, '
        f'{ranks[0]["ensemble"]["members_here"]} a rank): tagging of 2 x '
        f'{BATCH} clips and SED 51/1 of {BATCH} on every rank within '
        f'{worst:.3f} of the tolerance of one process\'s stacked output; '
        f'seconds a rank ' + ', '.join(
            f'{s:.2f}' for s in out['ensemble']['seconds']))
    out.update(_trace_and_summaries(config, flat, batches))
    out['filters'] = _check_filters()
    out['phase_s'] = time.perf_counter() - phase_start
    log(f'phase 13 took {out["phase_s"]:.1f} s ({card})')
    return launches, out


# -- phase 14: the tower configurations beyond the recipes -------------------
# (T, F, C, (pf, pt), dtype) of the generalised max pool, in the configs'
# (freq, time) notation: 14a's (2, 2) pools at L1 and L3 and a (1, 2) time
# pool at the same shapes; 14a's 1-D time pool on its f32 values (the 2-D
# tower has cut T by 4); 14b's (2, 1) pool on F = 5 at L15
TOWER_POOLS = [(FRAMES, 128, 16, (2, 2), torch.bfloat16),
               (FRAMES // 2, 64, 32, (2, 2), torch.bfloat16),
               (FRAMES, 128, 16, (1, 2), torch.bfloat16),
               (FRAMES // 2, 64, 32, (1, 2), torch.bfloat16),
               (FRAMES // 4, 1, 256, (1, 2), torch.float32),
               (FRAMES, 5, 256, (2, 1), torch.bfloat16)]
# (T, F, C, (st, sf), Cout) of 14b's residual crossings: L14 -> L16 across
# the pool on F = 5 (one (1, 2) window and the pad to 512) on the
# generalised average pool; L2 -> L4 (24 -> 64 channels across a (2, 1)
# pool on F = 40) on the row-pair kernel
TOWER_CROSSINGS = [(FRAMES, 5, 256, (1, 2), 512)]
TOWER_PAIR_CROSSINGS = [(FRAMES, 40, 24, 64)]
# (name, T, F, Cin, Cout, kt, kf) of the conv at shapes it takes padded:
# 14b's 3x3 layers at 24 channels, and a 2 x 2 and a 4 x 3 kernel
TOWER_CONVS = [('14b L0', FRAMES, 40, 1, 24, 3, 3),
               ('14b L2', FRAMES, 40, 24, 24, 3, 3),
               ('2x2', FRAMES, 64, 64, 64, 2, 2),
               ('4x3', FRAMES, 64, 64, 64, 4, 3)]
# 14a: the shallow tagging FBCRNN with time pools (time / 4 in the 2-D
# tower, / 2 in the 1-D one): the fused layers, and the frames a clip's
# seq_len keeps through them (ceil per pool)
TOWER_14A_POOLS = {'cnn_2d': [1, [2, 2], 1, [2, 2], 1, [2, 1], 1, [2, 1], 1],
                   'cnn_1d': [1, 2, 1, 1, 1]}
TOWER_14A_FUSED = [2, 4, 5, 6, 7, 8]
# (name, F, Cin, Cout) of 14b's 3x3 layers (the deep tower at 40 mel bins,
# 24 channels in its first four 2-D layers): F = 40, 20, 10 and 5, off the
# wgmma pair's old tile of 128 / F whole rows at a power of two F (L16
# runs at F = 2)
TOWER_14B_LAYERS = [('14b L0', 40, 1, 24), ('14b L2', 40, 24, 24),
                    ('14b L4', 20, 24, 64), ('14b L6', 20, 64, 64),
                    ('14b L8', 10, 64, 128), ('14b L10', 10, 128, 128),
                    ('14b L12', 5, 128, 256), ('14b L14', 5, 256, 256)]
# per 14b layer: designs, ms, cuDNN ms and bounds (one JSON line)
TOWER_LAYER_ROWS = []
TOWER_14B_FUSED = [6, 8, 10, 12, 14, 16]
POOLED = ('maxpool2d', 'maxpool2d_bwd')
CROSSED = ('avgpool2d', 'avgpool2d_bwd')
PADDED = ('conv2d_same_padded', 'conv2d_same_bwd_padded')


def _pool_work(n_in, n_out, window, elt, backward=False):
    """Bytes and compares of a max pool over ``n_in`` elements of
    ``elt`` bytes into ``n_out`` (backward: x and gy read, dx written)."""
    nbytes = elt * (2 * n_in + n_out if backward else n_in + n_out)
    return bound(nbytes, 0., n_out * (window - 1))


def check_tower_kernels(records):
    """Phases 2 and 2b at phase 14's shapes (B = 32 ten-second clips): the
    generalised max pool forward and backward (bit-exact, tie-heavy input:
    every frame from T - 100 on is 0), the generalised average pool of
    14b's crossing (bit-exact), the row-pair average at 14b's 24 -> 64
    crossing (bit-exact; a shape of the old kernel, printed only), and the
    conv and its backward at shapes the kernels take padded (Cout 24, 2 x
    2 and 4 x 3 kernels; one bf16 ulp forward and dx, 1e-3 * max|ref|
    dw), each with its kernel, plain, library and bound times, into
    ``records`` under the label 'towers'. Library calls: max_pool2d and
    avg_pool2d (channels-last) and their backward, cuDNN's bf16 conv with
    ``padding='same'`` and its backward on the input padded by XLA's
    SAME pads. Pools timed by CUDA-graph replay."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(14)

    def randn(*shape, scale=1.):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    for t, f, c, (pf, pt), dtype in TOWER_POOLS:
        x = randn(BATCH, t, f, c).to(dtype)
        x[:, t - 100:] = 0.
        shape = (BATCH, t, f, c, f'({pf}, {pt})', str(dtype)[6:])
        y = maxpool2d(x, pt, pf)
        ref = maxpool2d_plain(x, pt, pf)
        gy = randn(*y.shape).to(dtype)
        xn, gyn = _nchw(x), _nchw(gy)
        elt, n_in, n_out = x.element_size(), x.numel(), y.numel()
        torch.cuda.synchronize()
        _check('maxpool2d', shape, y, ref, 0.,
               graph_ms(lambda: maxpool2d(x, pt, pf)),
               graph_ms(lambda: maxpool2d_plain(x, pt, pf)),
               records['maxpool2d'], 'towers',
               graph_ms(lambda: F.max_pool2d(xn, (pt, pf))),
               _pool_work(n_in, n_out, pt * pf, elt))
        got = maxpool2d_bwd(x, gy, pt, pf)
        ref = maxpool2d_bwd_plain(x, gy, pt, pf)
        torch.cuda.synchronize()
        _, idx = F.max_pool2d(xn, (pt, pf), return_indices=True)
        _check('maxpool2d_bwd', shape, got, ref, 0.,
               graph_ms(lambda: maxpool2d_bwd(x, gy, pt, pf)),
               graph_ms(lambda: maxpool2d_bwd_plain(x, gy, pt, pf)),
               records['maxpool2d_bwd'], 'towers',
               graph_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                   gyn, xn, [pt, pf], [pt, pf], [0, 0], [1, 1], False, idx)),
               _pool_work(n_in, n_out, pt * pf, elt, backward=True))
        del x, y, gy, got, ref, idx, xn, gyn
    for t, f, c, (st, sf), cout in TOWER_CROSSINGS:
        x = randn(BATCH, t, f, c).to(torch.bfloat16)
        shape = (BATCH, t, f, c, f'({st}, {sf})', cout)
        y = avgpool2d(x, st, sf, cout)
        ref = avgpool2d_plain(x, st, sf, cout)
        gy = randn(*y.shape)
        xn = _nchw(x)
        gyn = _nchw(gy[..., :c].to(x.dtype).contiguous())
        n_in, n_out = x.numel(), y.numel() // cout * c
        torch.cuda.synchronize()
        _check('avgpool2d', shape, y, ref, 0.,
               graph_ms(lambda: avgpool2d(x, st, sf, cout)),
               graph_ms(lambda: avgpool2d_plain(x, st, sf, cout)),
               records['avgpool2d'], 'towers',
               graph_ms(lambda: F.avg_pool2d(xn, (st, sf))),
               bound(2 * n_in + 4 * y.numel(), 0., n_in))
        got = avgpool2d_bwd(gy, st, sf, x.shape, x.dtype)
        ref = avgpool2d_bwd_plain(gy, st, sf, x.shape, x.dtype)
        torch.cuda.synchronize()
        _check('avgpool2d_bwd', shape, got, ref, 0.,
               graph_ms(lambda: avgpool2d_bwd(gy, st, sf, x.shape, x.dtype)),
               graph_ms(lambda: avgpool2d_bwd_plain(gy, st, sf, x.shape,
                                                    x.dtype)),
               records['avgpool2d_bwd'], 'towers',
               graph_ms(lambda: torch.ops.aten.avg_pool2d_backward(
                   gyn, xn, [st, sf], [st, sf], [0, 0], False, True, None)),
               bound(4 * n_out + 2 * n_in, 0., n_in))
        del x, y, gy, got, ref, xn, gyn
    scratch = {name: new_record() for name in ('avgpool_freq2',
                                                'avgpool_freq2_bwd')}
    for t, f, c, cout in TOWER_PAIR_CROSSINGS:
        x = randn(BATCH, t, f, c).to(torch.bfloat16)
        gy = randn(BATCH, t, f // 2, cout)
        shape = (BATCH, t, f, c, cout)
        n = x.numel()
        got, ref = avgpool_freq2(x, cout), avgpool_freq2_plain(x, cout)
        torch.cuda.synchronize()
        _check('avgpool_freq2', shape, got, ref, 0.,
               graph_ms(lambda: avgpool_freq2(x, cout)),
               graph_ms(lambda: avgpool_freq2_plain(x, cout)),
               scratch['avgpool_freq2'], 'towers', None,
               bound(2 * n + 4 * got.numel(), 0., n))
        got = avgpool_freq2_bwd(gy, c, x.dtype)
        ref = avgpool_freq2_bwd_plain(gy, c, x.dtype)
        torch.cuda.synchronize()
        _check('avgpool_freq2_bwd', shape, got, ref, 0.,
               graph_ms(lambda: avgpool_freq2_bwd(gy, c, x.dtype)),
               graph_ms(lambda: avgpool_freq2_bwd_plain(gy, c, x.dtype)),
               scratch['avgpool_freq2_bwd'], 'towers', None,
               bound(2 * n + 2 * n, 0., n))
        del x, gy, got, ref
    for layer, t, f, cin, cout, kt, kf in TOWER_CONVS:
        x = randn(BATCH, t, f, cin).to(torch.bfloat16)
        w = randn(kt, kf, cin, cout, scale=(kt * kf * cin) ** -.5)
        b = randn(cout, scale=.1)
        gy = randn(BATCH, t, f, cout, scale=1e-3).to(torch.bfloat16)
        p, taps = BATCH * t * f, kt * kf
        shape = (layer, BATCH, t, f, cin, cout, f'{kt}x{kf}')
        pads = ((kf - 1) // 2, kf // 2, (kt - 1) // 2, kt // 2)
        xn, wn, bn = _nchw(x), _oihw(w), b.to(torch.bfloat16)
        xpn = _nchw(F.pad(x, (0, 0) + pads))
        kt_k, kf_k = kt + 1 - kt % 2, kf + 1 - kf % 2
        designs = conv_designs(f, cin, cout + -cout % 16, kt_k, kf_k)
        log(f'conv {shape}: runs as {kt_k}x{kf_k} -> {cout + -cout % 16} '
            f'channels, designs {designs}')
        want = {'fwd': 'entry' if cin < 16 else 'wgmma', 'dx': 'wgmma',
                'dw': 'entry' if cin < 16 else 'wgmma'}
        if {key: d['design'] for key, d in designs.items()} != want:
            raise AssertionError(f'conv {shape}: designs {designs}, '
                                 f'expected {want}')
        got, ref = conv2d_same(x, w, b), conv2d_same_plain(x, w, b)
        torch.cuda.synchronize()
        _check('conv2d_same (padded)', shape, got, ref,
               2. ** -7 * float(ref.float().abs().max()),
               cuda_ms(lambda: conv2d_same(x, w, b), reps=5),
               cuda_ms(lambda: conv2d_same_plain(x, w, b), reps=5),
               records['conv2d_same_padded'], 'towers',
               cuda_ms(lambda: F.conv2d(xn, wn, bn, padding='same'),
                       reps=5), conv_work(p, cin, cout, taps))
        del got, ref
        dx, dw = conv2d_same_bwd(x, w, gy)
        ref_dx, ref_dw = conv2d_same_bwd_plain(x, w, gy)
        torch.cuda.synchronize()
        gyn = _nchw(gy)
        _check('conv2d_same_bwd dx (padded)', shape, dx, ref_dx,
               2. ** -7 * float(ref_dx.float().abs().max()),
               cuda_ms(lambda: conv2d_same_bwd(x, w, gy), reps=5),
               cuda_ms(lambda: conv2d_same_bwd_plain(x, w, gy), reps=5),
               records['conv2d_same_bwd_padded'], 'towers',
               cuda_ms(lambda: torch.ops.aten.convolution_backward(
                   gyn, xpn, wn, None, [1, 1], [0, 0], [1, 1], False, [0, 0],
                   1, [True, True, False]), reps=5),
               conv_work(p, cin, cout, taps, backward=True))
        _check('conv2d_same_bwd dw (padded)', shape, dw, ref_dw,
               1e-3 * float(ref_dw.abs().max()), 0., 0.,
               records['conv2d_same_bwd_padded'], 'towers')
        del x, gy, dx, dw, ref_dx, ref_dw, xn, xpn
        torch.cuda.empty_cache()
    check_tower_layers(records)


def check_tower_layers(records):
    """14b's 3x3 layers (``TOWER_14B_LAYERS``, B = 32, T = 500): each
    pass's design must be the entry (forward and dw at Cin < 16) or the
    wgmma kernels; the forward and the backward (dx and dw) against their
    plain versions within the conv gates, dw the same in two runs; each
    timed (CUDA events) beside cuDNN's bf16 forward and
    ``convolution_backward`` (both gradients) on the channels-last
    tensors, with its bound and share; at L0 (Cin = 1) also the dx GEMM
    alone against cuDNN's dgrad (:func:`entry_dx`). The errors join the
    conv pair's ``max_abs_err``; the times are printed, per layer and as
    one JSON line, and stay out of the kernels line's sums."""
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(41)
    scratch = {name: new_record() for name in ('conv2d_same',
                                                'conv2d_same_bwd')}

    def randn(*shape, scale=1.):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    for layer, f, cin, cout in TOWER_14B_LAYERS:
        x = randn(BATCH, FRAMES, f, cin).to(torch.bfloat16)
        w = randn(3, 3, cin, cout, scale=(9 * cin) ** -.5)
        b = randn(cout, scale=.1)
        gy = randn(BATCH, FRAMES, f, cout, scale=1e-3).to(torch.bfloat16)
        p = BATCH * FRAMES * f
        shape = (layer, BATCH, FRAMES, f, cin, cout)
        # the channels as the kernels take them (Cout to 16, Cin >= 16 to 8)
        designs = conv_designs(f, cin + (-cin % 8 if cin >= 16 else 0),
                               cout + -cout % 16)
        want = {'fwd': 'entry' if cin < 16 else 'wgmma', 'dx': 'wgmma',
                'dw': 'entry' if cin < 16 else 'wgmma'}
        if {key: d['design'] for key, d in designs.items()} != want:
            raise AssertionError(f'conv {shape}: designs {designs}, '
                                 f'expected {want}')
        xn, wn, bn, gyn = _nchw(x), _oihw(w), b.to(torch.bfloat16), _nchw(gy)
        row = {'layer': layer, 'F': f, 'Cin': cin, 'Cout': cout,
               'design': designs}
        got, ref = conv2d_same(x, w, b), conv2d_same_plain(x, w, b)
        torch.cuda.synchronize()
        row['fwd'] = [cuda_ms(lambda: conv2d_same(x, w, b), reps=5),
                      cuda_ms(lambda: F.conv2d(xn, wn, bn, padding=1),
                              reps=5), conv_work(p, cin, cout)[0]]
        _check('conv2d_same (14b layer)', shape, got, ref,
               2. ** -7 * float(ref.float().abs().max()), row['fwd'][0],
               cuda_ms(lambda: conv2d_same_plain(x, w, b), reps=2),
               scratch['conv2d_same'], 'towers', row['fwd'][1],
               conv_work(p, cin, cout))
        del got, ref
        dx, dw = conv2d_same_bwd(x, w, gy)
        ref_dx, ref_dw = conv2d_same_bwd_plain(x, w, gy)
        torch.cuda.synchronize()
        row['bwd'] = [
            cuda_ms(lambda: conv2d_same_bwd(x, w, gy), reps=5),
            cuda_ms(lambda: torch.ops.aten.convolution_backward(
                gyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [True, True, False]), reps=5),
            conv_work(p, cin, cout, backward=True)[0]]
        _check('conv2d_same_bwd dx (14b layer)', shape, dx, ref_dx,
               2. ** -7 * float(ref_dx.float().abs().max()), row['bwd'][0],
               cuda_ms(lambda: conv2d_same_bwd_plain(x, w, gy), reps=2),
               scratch['conv2d_same_bwd'], 'towers', row['bwd'][1],
               conv_work(p, cin, cout, backward=True))
        _check('conv2d_same_bwd dw (14b layer)', shape, dw, ref_dw,
               1e-3 * float(ref_dw.abs().max()), 0., 0.,
               scratch['conv2d_same_bwd'], 'towers')
        if not torch.equal(dw, conv2d_same_bwd(x, w, gy)[1]):
            raise AssertionError(f'conv2d_same_bwd {shape}: dw differs '
                                 f'between two runs')
        del dx, dw, ref_dx, ref_dw
        if cin < 16:
            row['dx'] = entry_dx('towers', shape, x, w, gy)
        log(f'14b layer {layer} ({f}, {cin} -> {cout}): design '
            + ' '.join(f'{key}={d["design"]} (ring {d["stages"]}, '
                       f'{d["smem"] / 1024:.0f} KiB)'
                       for key, d in designs.items())
            + ''.join(f' | {key} {ms:.3f} ms, cuDNN {lib:.3f}, bound '
                      f'{bnd:.3f}, share {bnd / ms:.2f}, / cuDNN '
                      f'{ms / lib:.2f}'
                      for key, (ms, lib, bnd) in (
                          (k, row[k]) for k in ('fwd', 'bwd', 'dx')
                          if k in row)))
        TOWER_LAYER_ROWS.append(row)
        del x, gy, xn, gyn
        torch.cuda.empty_cache()
    log('14b layers: ' + json.dumps(TOWER_LAYER_ROWS))
    for name, rec in scratch.items():
        records[name]['max_abs_err'] = max(records[name]['max_abs_err'],
                                           rec['max_abs_err'])


def _tower_config(name, fuse_bn=False, augment=True):
    """Phase 14's configurations at full width: '14a' the shallow tagging
    FBCRNN of the AudioSet recipe (527 classes, no strong loss) with time
    pools; '14b' the deep recipe at 40 mel bins (its pools meet F = 5 at
    the fourth) with 24 channels in its first four 2-D layers; '14c' the
    shallow recipe without norms in either tower and with elu."""
    if name == '14a':
        config = _config('shallow', 527, fuse_bn, augment, strong=0.)
        for tower, pools in TOWER_14A_POOLS.items():
            config['cnn'][tower]['pool_size'] = pools
    elif name == '14b':
        config = _config('deep', 527, fuse_bn, augment, strong=0.,
                         number_of_filters=40)
        config['cnn']['cnn_2d']['out_channels'][:4] = [24] * 4
    else:
        config = _config('shallow', 10, augment=augment)
        for tower in ('cnn_2d', 'cnn_1d'):
            config['cnn'][tower].update(norm=None, activation_fn='elu')
    return config


def _train_towers(make_model, k, kernels, label, strong=False,
                  conv_order=True, gru_order=False, profile=False,
                  steps=TRAIN_STEPS):
    """``steps`` ``Trainer`` steps of a phase-14 (or 15) model at 32 ten-second
    clips with augmentation on (the AudioSet recipe's Adam: lr 1e-4,
    clipping 0.1), the BiCRNN's strong batches with ``strong``: every
    kernel of ``kernels`` must launch and every loss be finite; then the
    card-vs-CPU step (:func:`_card_vs_cpu`; with ``conv_order`` the CPU's
    noise with its bf16 convs' summation order too). Returns the launch
    counts and steps/s, clips/s and peak memory. With ``profile`` one
    more step is profiled by kernel family (:func:`_profile_step`)."""
    from pb_sed_tpu_torch.train.optimizer import Adam
    from pb_sed_tpu_torch.train.trainer import Trainer
    model = make_model(augment=True).to('cuda')
    stft = model.module.feature_extractor.stft
    batches = _train_batches(stft, 4, BATCH, 10, seed=1, k=k, strong=strong)
    step_log = _StepLog()
    trainer = Trainer(model, optimizer=Adam(**_DEEP_RECIPE['adam']),
                      stop_trigger=(steps, 'iteration'))
    trainer.register_hook(step_log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    collect_garbage()
    trainer.train(batches * (steps // len(batches)))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log(f'launches in the {label} training run: {launches}')
    for kernel in kernels:
        if launches[kernel] <= 0:
            raise AssertionError(f'kernel {kernel} never launched in the '
                                 f'{label} training run')
    log(f'{label} loss per step: ' + ', '.join(
        f'{x:.5f}' for x in step_log.losses))
    if len(step_log.losses) != steps or not np.isfinite(
            step_log.losses).all():
        raise AssertionError(f'{label} training losses: {step_log.losses}')
    steady = np.diff(step_log.times)[2:]
    metrics = {'steps_per_s': 1 / steady.mean(),
               'clips_per_s': BATCH / steady.mean(),
               'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f'{label} training: {metrics["steps_per_s"]:.3f} steps/s = '
        f'{metrics["clips_per_s"]:.1f} clips/s over steps 3-{steps} '
        f'(batch {BATCH} x 10 s clips, augmentation on, host clock), peak '
        f'{metrics["peak_gib"]:.2f} GiB')
    if profile:
        _profile_step(trainer, batches[0], label)
    del trainer, model
    torch.cuda.empty_cache()
    _card_vs_cpu(make_model, stft, k, strong, conv_order, gru_order)
    return launches, metrics


def _check_fused(model, want, label):
    fused = sorted(model.module.cnn.cnn_2d.fused)
    log(f'{label}: fused layers {fused}')
    if fused != want:
        raise AssertionError(f'{label}: fused layers {fused} != {want}')


def phase_towers(earlier):
    """Phase 14. 14a: the time-pooled tagging FBCRNN (``fuse_bn``) serves
    3 x 32 clips by tagging, boundaries and SED 51/1 (T = 500 frames
    pooled to 62 while a full clip's seq_len becomes ceil(500 / 8) = 63)
    and trains 8 steps. 14b: the odd deep tower, unfused and with
    ``fuse_bn`` (which must agree with the unfused tags), tags 3 x 32
    clips and trains 8 steps each. 14c: the norm-free elu tower tags 3 x
    32 clips. Each served run is held against the CPU, each trained one
    by the card-vs-CPU step, each path's launch counters read; clips/s,
    steps/s and peak memory are printed beside ``earlier`` (phases 3-5).
    Returns (launches by path, the measurements)."""
    from pb_sed_tpu_torch.models import base
    launches, out = {}, {}
    # 14a
    config = _tower_config('14a', fuse_bn=True)
    flat = _random_flat(config)
    model = _model(config, flat, 'cuda')
    _check_fused(model, TOWER_14A_FUSED, '14a')
    stft = model.module.feature_extractor.stft
    batches = _synthetic_batches(stft)
    t_out = stft.num_frames(10 * 16000) // 4 // 2

    def pooled(name, seq_len):
        return 1 if name == 'tagging' else min(-(-seq_len // 8), t_out)

    over = [sl for batch in batches for sl in batch['seq_len']
            if -(-int(sl) // 8) > t_out]
    log(f'14a: T {stft.num_frames(10 * 16000)} -> {t_out} pooled frames; '
        f'{len(over)} clips keep a seq_len above it (ceil(seq_len / 8) = '
        f'{t_out + 1})')
    if not over:
        raise AssertionError('14a: no clip whose pooled seq_len exceeds T')
    methods = _methods(base)[:3]
    stats = out.setdefault('14a_serving', {})
    results, launches['towers_14a_serving'] = _serve(
        model, methods, batches, 527, '14a',
        FORWARD + ('bnrelu_conv2d_same', 'maxpool2d'), stats=stats,
        frames=pooled)
    _agree_with_cpu(_model(config, flat), methods, results, batches[1])
    del model
    torch.cuda.empty_cache()
    launches['towers_14a_training'], out['14a_training'] = _train_towers(
        lambda augment: _model(_tower_config('14a', True, augment), flat),
        527, SHALLOW + FUSED + POOLED, '14a')
    # 14b, unfused and fuse_bn, on the same weights
    flat = _random_flat(_tower_config('14b'))
    tags = None
    for fuse_bn in (False, True):
        label = '14b_fuse_bn' if fuse_bn else '14b'
        config = _tower_config('14b', fuse_bn)
        model = _model(config, flat, 'cuda')
        _check_fused(model, TOWER_14B_FUSED if fuse_bn else [], label)
        batches = _synthetic_batches(model.module.feature_extractor.stft)
        methods = _methods(base)[:1]
        stats = out.setdefault(f'{label}_serving', {})
        results, launches[f'towers_{label}_serving'] = _serve(
            model, methods, batches, 527, label,
            FORWARD + ('maxpool2d', 'avgpool_freq2', 'avgpool2d',
                       'conv2d_same_padded')
            + (FUSED[:1] if fuse_bn else ()), stats=stats)
        if tags is None:
            tags = results['tagging']
        else:
            err = max(float(np.abs(results['tagging'][c] - tags[c]).max())
                      for c in tags)
            tol = 1e-4 + 3e-2 * max(float(np.abs(v).max())
                                    for v in tags.values())
            log(f'14b fuse_bn vs unfused tags: max|d| {err:.3e} tol '
                f'{tol:.3e}')
            if not err <= tol:
                raise AssertionError(f'14b fuse_bn and unfused tags differ '
                                     f'by {err} > {tol}')
        _agree_with_cpu(_model(config, flat), methods, results, batches[1])
        del model
        torch.cuda.empty_cache()
        launches[f'towers_{label}_training'], out[f'{label}_training'] = \
            _train_towers(
                lambda augment, fb=fuse_bn: _model(
                    _tower_config('14b', fb, augment), flat),
                527, DEEP + POOLED + CROSSED + PADDED
                + (FUSED if fuse_bn else ()), label, profile=not fuse_bn)
    # 14c
    config = _tower_config('14c')
    flat = _random_flat(config)
    if any('.norm_' in key for key in flat if key.startswith(
            ('params.cnn.', 'batch_stats.cnn.'))):
        raise AssertionError('14c: a norm-free tower holds norm variables')
    model = _model(config, flat, 'cuda')
    batches = _synthetic_batches(model.module.feature_extractor.stft)
    methods = _methods(base)[:1]
    stats = out.setdefault('14c_serving', {})
    results, launches['towers_14c_serving'] = _serve(
        model, methods, batches, 10, '14c', stats=stats)
    _agree_with_cpu(_model(config, flat), methods, results, batches[1])
    del model
    torch.cuda.empty_cache()
    log('phase 14 beside phases 3-5 (host clock, B = 32): tagging clips/s '
        + ', '.join(f'{key} {out[key]["tagging_clips_per_s"]:.1f}'
                    for key in out if key.endswith('_serving'))
        + f' vs shallow (phase 3) {earlier["serving"]["tagging_clips_per_s"]:.1f}'
        + '; training steps/s ' + ', '.join(
            f'{key} {out[key]["steps_per_s"]:.3f}' for key in out
            if key.endswith('_training'))
        + f' vs shallow (phase 4) {earlier["shallow"]["steps_per_s"]:.3f}, '
        f'deep (phase 5) {earlier["deep"]["steps_per_s"]:.3f}; peak GiB '
        + ', '.join(f'{key} {value["peak_gib"]:.2f}'
                    for key, value in out.items())
        + f' vs shallow serving {earlier["serving"]["peak_gib"]:.2f}, '
        f'training {earlier["shallow"]["peak_gib"]:.2f}, deep training '
        f'{earlier["deep"]["peak_gib"]:.2f}')
    return launches, out


# -- phase 15: GRU widths off the kernels' own and compute_dtype='float32' --
# (D, B, T, H) of the GRU at widths above 512 (the cluster design of 16
# blocks): training and tagging, also at its widest H, 2048, and
# sliding-window SED at window 51, shift 1; and at H = 200 (run as 256 in
# the cluster kernels): the BiCRNN's training shape. At SED's shapes the
# backward is checked on the first WIDTH_CHECK_ROWS rows (the rows'
# recurrences are independent: the plain backward of all 16 000 would
# hold ~70 GB) and timed on all of them.
WIDTH_GRU_SHAPES = [(2, BATCH, FRAMES, 768), (2, BATCH, FRAMES, 1024),
                    (2, BATCH, FRAMES, 2048), (2, BATCH * FRAMES, 51, 768),
                    (2, BATCH * FRAMES, 51, 1024), (2, BATCH, FRAMES, 200)]
WIDTH_CHECK_ROWS = 2048
WIDE = ('gru_scan_wide', 'gru_scan_bwd_wide')
PADDED_GRU = ('gru_scan_padded', 'gru_scan_bwd_padded')
# at SED's shape the backward is not timed at H = 1024: the wrapper's f32
# weight-gradient contraction over 1.6 M rows would take the card's memory
# to ~83 GB beside the shape's operands
WIDTH_BWD_UNTIMED = {(2, BATCH * FRAMES, 51, 1024)}
F32 = ('conv2d_same_f32', 'conv2d_same_f32_bwd')
F32_ENTRY = ('conv2d_same_f32_entry', 'conv2d_same_f32_bwd_entry')
# the recipes' entry layers (F, Cin -> Cout) on the f32 entry kernels
F32_ENTRY_LAYERS = [('shallow L0', 128, 1, 16), ('deep L0', 128, 1, 32),
                    ('BiCRNN L0', 128, 11, 16)]
# 14b's 3x3 layers off a power-of-two F and a layer at Cout = 10 (padded
# to 16 for the forward and dw; its dx from 10 channels) in f32
F32_OFF_TILE_LAYERS = TOWER_14B_LAYERS[1:] + [('Cout 10', 40, 24, 10)]
# the f32 kernels by the profiler's names: the forward-type GEMM (the
# forward, or the dx inside the backward) with its weights' split on
# either design, and the dw pass with its reduce
F32_KERNELS = {'gemm': ('conv2d_f32_wgmma_kernel', 'conv2d_f32_split_kernel',
                        'conv2d_f32_entry_kernel',
                        'conv2d_f32_entry_split_kernel'),
               'dw': ('conv2d_f32_dw_',)}
# 15a's f32 towers; 15b's and 15c's hidden sizes
F32_PATHS = ('cnn_2d', 'cnn_1d')
WIDE_HIDDEN = 768
PADDED_HIDDEN = 200
# an H above 512 the cluster design takes padded (to 768)
PADDED_WIDE_HIDDEN = 600


def _f32_work(p, cin, cout, taps=9, backward=False, ffma=False):
    """The least time of the f32 SAME conv (forward, or dx + dw) over
    ``p`` pixels, f32 activations, weights and bias: its bytes, or its
    f32 products on the 3xTF32 route (3 TF32 products each at 495
    TFLOP/s, faster than FFMA's 67); ``ffma=True``: on the FFMA route."""
    if backward:
        nbytes = 4 * (2 * p * cin + taps * cin * cout + p * cout
                      + taps * cin * cout)
        flops = 4. * p * taps * cin * cout
    else:
        nbytes = 4 * (p * cin + taps * cin * cout + cout + p * cout)
        flops = 2. * p * taps * cin * cout
    if ffma:
        return bound(nbytes, 0., flops)
    return bound(nbytes, tf32_flops=3. * flops)


def f32_designs_wanted(cin, cout):
    """The f32 conv's design of each pass of a (Cin -> Cout) layer, as the
    rule has it: the entry kernels at Cin < 16 (all three passes) and for
    the dx of a layer with Cout < 16 (a GEMM from fewer than 16 channels),
    3xTF32 on wgmma everywhere else."""
    if cin < 16:
        return dict.fromkeys(('fwd', 'dx', 'dw'), 'entry')
    return {'fwd': '3xtf32', 'dx': 'entry' if cout < 16 else '3xtf32',
            'dw': '3xtf32'}


def _assert_f32_layer(label, layer, f, cin, cout):
    """Log each pass's f32 design at a 3x3 layer (kernel, launch channels,
    tile of width x rows pixels, ring, shared memory) and assert the rule
    (:func:`f32_designs_wanted`), the kernel whole (no tap blocks)."""
    from pb_sed_tpu_torch.ops.kernels.conv import conv_f32_designs
    designs = conv_f32_designs(f, cin, cout)
    log(f'{label}: f32 conv design {layer} ({f}, {cin} -> {cout}): '
        + '; '.join(f'{key} {v["design"]} at {v["channels"]}, tile '
                    f'{v["tile"][0]} x {v["tile"][1]}, {v["stages"]} '
                    f'stages, {v["smem"] / 1024:.0f} KiB'
                    for key, v in designs.items()))
    want = f32_designs_wanted(cin, cout)
    got = {key: v['design'] for key, v in designs.items()}
    if got != want or any(v['taps'] != (3, 3) for v in designs.values()):
        raise AssertionError(f'{label}: f32 conv at {layer} runs '
                             f'{designs}, not {want}')


def check_width_kernels(records):
    """Phase 15d, phases 2 and 2b for this phase's kernels (B = 32 ten-second
    clips): the GRU pair at ``WIDTH_GRU_SHAPES`` (the cluster design of 16
    blocks at 768, 1024 and 2048, the padded width 200) against its plain
    version at the real H
    (the GRU ceiling, 5.3e-3 and 5.3e-3 of each gradient's largest entry),
    with the design each pass runs, cuDNN's bf16 GRU as the library call
    (forward at every shape, backward at B = 32) and the bound; and the f32
    conv and its backward at the shallow tower's nine 3x3 shapes against
    its plain version (PyTorch's own im2col and f32 GEMM, TF32 and cuDNN
    off: 2e-5 of the largest entry forward and dx, 1e-4 for dw), each
    timed beside cuDNN's f32 conv with TF32 off (the library call; its dw
    also held against the plain version, printed) and its bound (3xTF32:
    3 TF32 products at 495 TFLOP/s per f32 product, or bytes; the FFMA
    route's at 67 TFLOP/s printed beside), with the design each pass runs
    (3xTF32 at L1-L8, the entry kernels at L0, asserted), each largest
    error as a fraction of its gate, and the backward without dx, into
    ``records`` under the label 'widths'; then the recipes' three entry
    layers (:func:`check_f32_entry_layers`)."""
    from pb_sed_tpu_torch.ops.kernels.conv import (conv2d_same_f32,
                                                   conv2d_same_f32_bwd,
                                                   conv2d_same_f32_bwd_plain,
                                                   conv2d_same_f32_plain)
    from pb_sed_tpu_torch.ops.kernels.functions import full_f32
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(15)
    library = []

    def randn(*shape, scale=1.):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    for d, b, t, h in WIDTH_GRU_SHAPES:
        shape = (d, b, t, h)
        xw = randn(d, b, t, 3 * h).to(torch.bfloat16)
        w_hh = randn(d, h, 3 * h, scale=h ** -.5)
        b_hh = randn(d, 3 * h, scale=.1)
        h0 = torch.zeros(d, b, h, device=dev)
        for key, v in gru_designs(d, b, t, h).items():
            if v is None:
                log(f'gru design {shape} {key}: none (the fused backward '
                    f'stops at 512)')
                continue
            log(f'gru design {shape} {key}: {v["design"]} at H = '
                f'{v["hidden"]}, {v["cluster"]} blocks of {v["units"]} '
                f'units, {v["rows"]} rows a cluster, '
                f'{v["smem"] / 1024:.0f} KiB shared memory, w_hh '
                f'{v["resident"] / 1024:.0f} KiB resident and '
                f'{v["streamed"] / 1024:.0f} KiB streamed a block and step, '
                f'{v["coresident"]} co-resident clusters')
            # at B = 32 the cluster designs, above 512 of 16 blocks of
            # H / 16 units and 16 rows
            want = (('cluster', 16, h // 16, 16) if h > 512
                    else ('cluster', v['cluster'], 32, v['rows']))
            got = (v['design'], v['cluster'], v['units'], v['rows'])
            if key != 'bwd_fused' and b == BATCH and got != want:
                raise AssertionError(f'GRU {key} at {shape} runs {got}, '
                                     f'not {want}')
        fwd = records['gru_scan_wide' if h > 512 else 'gru_scan_padded']
        bwd = records['gru_scan_bwd_wide' if h > 512
                      else 'gru_scan_bwd_padded']
        y = gru_scan(xw, w_hh, b_hh, h0)
        ref = gru_scan_plain(xw, w_hh, b_hh, h0)
        torch.cuda.synchronize()
        k_ms = cuda_ms(lambda: gru_scan(xw, w_hh, b_hh, h0), reps=5)
        g = randn(d, b, t, h, scale=1e-2)
        lib = cudnn_gru(xw, w_hh, b_hh, h0, ref, g if b == BATCH else None)
        lib.update(shape=shape, fwd_kernel_ms=k_ms)
        _check('gru_scan', shape, y, ref, 5.3e-3, k_ms,
               cuda_ms(lambda: gru_scan_plain(xw, w_hh, b_hh, h0), reps=3,
                       warmup=1), fwd, 'widths', lib['fwd'],
               gru_work(d, b, t, h))
        _log_gru_step('fwd', shape, k_ms, lambda: gru_scan(xw, w_hh, b_hh,
                                                           h0))
        log(f'cudnn gru {shape} forward: {lib["fwd"]:.3f} ms; gru_scan / '
            f'cuDNN {k_ms / lib["fwd"]:.3f}')
        del ref
        torch.cuda.empty_cache()
        args = (xw, w_hh, b_hh, h0, y, g)
        if shape in WIDTH_BWD_UNTIMED:
            k_ms = 0.
            log(f'gru_scan_bwd {shape}: not timed (memory)')
        else:
            k_ms = cuda_ms(lambda: gru_scan_bwd(*args), reps=3)
            _log_gru_step('bwd', shape, k_ms, lambda: gru_scan_bwd(*args))
        rows = min(b, WIDTH_CHECK_ROWS)
        part = (xw[:, :rows], w_hh, b_hh, h0[:, :rows], y[:, :rows],
                g[:, :rows])
        grads = gru_scan_bwd(*part)
        refs = gru_scan_bwd_plain(*part)
        torch.cuda.synchronize()
        # the sums hold the shapes timed whole, kernel and plain: B = 32
        whole = rows == b
        p_ms = cuda_ms(lambda: gru_scan_bwd_plain(*part), reps=2,
                       warmup=1) if whole else 0.
        checked = (d, rows, t, h)
        for i, name in enumerate(('dxw', 'dw_hh', 'db_hh', 'dh0')):
            first = i == 0 and whole
            _check(f'gru_scan_bwd {name}', checked, grads[i], refs[i],
                   5.3e-3 * float(refs[i].float().abs().max()),
                   k_ms if first else 0., p_ms if first else 0., bwd,
                   'widths', lib.get('bwd') if first else None,
                   gru_work(d, b, t, h, True) if first else None)
        again = gru_scan_bwd(*part)
        if not all(torch.equal(a, r) for a, r in zip(grads, again)):
            raise AssertionError(f'gru_scan_bwd at {checked}: a second run '
                                 f'differs')
        if 'bwd' in lib:
            lib['bwd_kernel_ms'] = k_ms
        library.append({key: v for key, v in lib.items()
                        if key != 'kernels'})
        del xw, y, g, args, part, grads, refs, again
        torch.cuda.empty_cache()
    for layer, f, cin, cout in CONV_LAYERS:
        # 3xTF32 at L1-L8, the entry kernels at L0 (Cin = 1)
        _assert_f32_layer('15d', layer, f, cin, cout)
        x = randn(BATCH, FRAMES, f, cin)
        w = randn(3, 3, cin, cout, scale=(9 * cin) ** -.5)
        bias = randn(cout, scale=.1)
        gy = randn(BATCH, FRAMES, f, cout, scale=1e-3)
        p = BATCH * FRAMES * f
        shape = (layer, BATCH, FRAMES, f, cin, cout)
        xn = _nchw(x)
        wn = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        gyn = _nchw(gy)

        def in_f32(call):
            with full_f32():
                return call()

        fractions = {}

        def gated(key, got, ref, gate):
            tol = gate * float(ref.abs().max())
            fractions[key] = float((got - ref).abs().max()) / tol
            return tol

        got, ref = conv2d_same_f32(x, w, bias), conv2d_same_f32_plain(
            x, w, bias)
        torch.cuda.synchronize()
        work = _f32_work(p, cin, cout)
        _check('conv2d_same_f32', shape, got, ref,
               gated('fwd', got, ref, 2e-5),
               cuda_ms(lambda: conv2d_same_f32(x, w, bias), reps=5),
               cuda_ms(lambda: conv2d_same_f32_plain(x, w, bias), reps=5),
               records['conv2d_same_f32'], 'widths',
               cuda_ms(lambda: in_f32(lambda: F.conv2d(xn, wn, bias,
                                                       padding=1)), reps=5),
               work)
        ffma = _f32_work(p, cin, cout, ffma=True)
        log(f'  bound {work[0]:.3f} ms (3xTF32 or bytes; {work[1]}), FFMA '
            f'route {ffma[0]:.3f} ms ({ffma[1]})')
        del got, ref
        dx, dw = conv2d_same_f32_bwd(x, w, gy)
        ref_dx, ref_dw = conv2d_same_f32_bwd_plain(x, w, gy)
        torch.cuda.synchronize()
        work = _f32_work(p, cin, cout, backward=True)
        _check('conv2d_same_f32_bwd dx', shape, dx, ref_dx,
               gated('dx', dx, ref_dx, 2e-5),
               cuda_ms(lambda: conv2d_same_f32_bwd(x, w, gy), reps=5),
               cuda_ms(lambda: conv2d_same_f32_bwd_plain(x, w, gy), reps=5),
               records['conv2d_same_f32_bwd'], 'widths',
               cuda_ms(lambda: in_f32(
                   lambda: torch.ops.aten.convolution_backward(
                       gyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False,
                       [0, 0], 1, [True, True, False])), reps=5),
               work)
        ffma = _f32_work(p, cin, cout, backward=True, ffma=True)
        no_dx = cuda_ms(lambda: conv2d_same_f32_bwd(x, w, gy, need_dx=False),
                        reps=5)
        log(f'  bound {work[0]:.3f} ms (3xTF32 or bytes; {work[1]}), FFMA '
            f'route {ffma[0]:.3f} ms ({ffma[1]}); without dx (what a layer '
            f'whose input needs no gradient runs) {no_dx:.3f} ms')
        _check('conv2d_same_f32_bwd dw', shape, dw, ref_dw,
               gated('dw', dw, ref_dw, 1e-4), 0., 0.,
               records['conv2d_same_f32_bwd'], 'widths')
        log(f'  largest errors as a fraction of their gates at {layer}: '
            + json.dumps({k: round(v, 4) for k, v in fractions.items()}))
        lib_dw = in_f32(lambda: torch.ops.aten.convolution_backward(
            gyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False]))[1].permute(2, 3, 1, 0)
        log(f'  cuDNN f32 dw (TF32 off) at {layer} against the plain '
            f'version (cuDNN off): max|d| '
            f'{float((lib_dw - ref_dw).abs().max()):.3e}, the kernel '
            f'{float((dw - ref_dw).abs().max()):.3e}')
        if not torch.equal(dw, conv2d_same_f32_bwd(x, w, gy)[1]):
            raise AssertionError(f'conv2d_same_f32_bwd dw at {shape}: a '
                                 f'second run differs')
        if not torch.equal(dw, conv2d_same_f32_bwd(x, w, gy,
                                                   need_dx=False)[1]):
            raise AssertionError(f'conv2d_same_f32_bwd dw at {shape} '
                                 f'differs without dx')
        del x, gy, dx, dw, ref_dx, ref_dw, xn, gyn
        torch.cuda.empty_cache()
    check_f32_entry_layers(records, randn)
    check_f32_off_tile_layers(records, randn)
    log('gru library (phase 15): ' + json.dumps(library))
    _padded_width_choice(randn)
    _padded_wide_width(randn)


# the f32 entry kernels by the profiler's names: the forward-type GEMM
# (the forward, or the dx inside the backward) with its weights' split,
# and the dw pass with its reduce
F32_ENTRY_KERNELS = {'fwd': ('conv2d_f32_entry',),
                     'dx': ('conv2d_f32_entry',),
                     'dw': ('conv2d_f32_dw_entry', 'conv2d_f32_dw_reduce')}


def _f32_pass_work(p, cin, cout, taps=9):
    """The least time of one pass of the f32 conv over ``p`` pixels: its
    activations read and written once (forward: x in, y out; dx: gy in,
    dx out; dw: x and gy in) and its weights, or its 3xTF32 products (3
    TF32 products at 495 TFLOP/s per f32 product)."""
    nbytes = 4 * (p * (cin + cout) + taps * cin * cout)
    return bound(nbytes, tf32_flops=3. * 2. * p * taps * cin * cout)


def check_f32_entry_layers(records, randn):
    """Phase 15d at the recipes' three entry layers (``F32_ENTRY_LAYERS``,
    B = 32 ten-second clips) on the f32 entry kernels
    (``csrc/conv2d_f32_entry.cuh``): the design of each pass (asserted
    'entry'); the forward, dx and dw against the plain versions (2e-5 of
    the largest entry forward and dx, 1e-4 for dw); dw equal in every bit
    on a rerun and without dx; each pass's device time (torch.profiler:
    the entry kernels alone, the weights' split with the GEMM, the dw with
    its reduce) beside its bound, its share of the bound and cuDNN's f32
    call with TF32 off (``F.conv2d``; ``convolution_backward`` for the
    input alone and for the weight alone), into
    ``records['conv2d_same_f32_entry']`` and
    ``records['conv2d_same_f32_bwd_entry']`` (label 'widths')."""
    from pb_sed_tpu_torch.ops.kernels.conv import (conv2d_same_f32,
                                                   conv2d_same_f32_bwd,
                                                   conv2d_same_f32_bwd_plain,
                                                   conv2d_same_f32_plain,
                                                   conv_f32_designs)
    from pb_sed_tpu_torch.ops.kernels.functions import full_f32

    def in_f32(call):
        with full_f32():
            return call()

    rows = {}
    for layer, f, cin, cout in F32_ENTRY_LAYERS:
        designs = conv_f32_designs(f, cin, cout)
        log(f'f32 entry design {layer} ({f}, {cin} -> {cout}): '
            + json.dumps(designs))
        if {v['design'] for v in designs.values()} != {'entry'}:
            raise AssertionError(f'f32 conv at {layer}: {designs}, not the '
                                 f'entry kernels')
        x = randn(BATCH, FRAMES, f, cin)
        w = randn(3, 3, cin, cout, scale=(9 * cin) ** -.5)
        bias = randn(cout, scale=.1)
        gy = randn(BATCH, FRAMES, f, cout, scale=1e-3)
        p = BATCH * FRAMES * f
        shape = (layer, BATCH, FRAMES, f, cin, cout)
        xn, gyn = _nchw(x), _nchw(gy)
        wn = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        row = {}
        got, ref = conv2d_same_f32(x, w, bias), conv2d_same_f32_plain(
            x, w, bias)
        ms = device_ms(lambda: conv2d_same_f32(x, w, bias),
                       F32_ENTRY_KERNELS['fwd'])
        lib = device_ms(lambda: in_f32(lambda: F.conv2d(xn, wn, bias,
                                                        padding=1)))
        work = _f32_pass_work(p, cin, cout)
        _check('conv2d_same_f32_entry', shape, got, ref,
               2e-5 * float(ref.abs().max()), ms,
               device_ms(lambda: conv2d_same_f32_plain(x, w, bias), reps=2),
               records['conv2d_same_f32_entry'], 'widths', lib, work)
        row['fwd'] = [ms, lib, work[0]]
        del got, ref
        dx, dw = conv2d_same_f32_bwd(x, w, gy)
        ref_dx, ref_dw = conv2d_same_f32_bwd_plain(x, w, gy)
        plain_ms = device_ms(lambda: conv2d_same_f32_bwd_plain(x, w, gy),
                             reps=2)
        for name, got, ref, gate in (('dx', dx, ref_dx, 2e-5),
                                     ('dw', dw, ref_dw, 1e-4)):
            keep = name == 'dx'
            ms = device_ms(lambda: conv2d_same_f32_bwd(x, w, gy,
                                                       need_dx=keep),
                           F32_ENTRY_KERNELS[name])
            lib = device_ms(lambda: in_f32(
                lambda: torch.ops.aten.convolution_backward(
                    gyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False,
                    [0, 0], 1, [keep, not keep, False])))
            work = _f32_pass_work(p, cin, cout)
            # the plain backward is timed whole, once (beside dx)
            _check(f'conv2d_same_f32_bwd_entry {name}', shape, got, ref,
                   gate * float(ref.abs().max()), ms,
                   plain_ms if keep else 0.,
                   records['conv2d_same_f32_bwd_entry'], 'widths', lib,
                   work)
            row[name] = [ms, lib, work[0]]
        if not torch.equal(dw, conv2d_same_f32_bwd(x, w, gy)[1]):
            raise AssertionError(f'conv2d_same_f32_bwd dw at {shape}: a '
                                 f'second run differs')
        if not torch.equal(dw, conv2d_same_f32_bwd(x, w, gy,
                                                   need_dx=False)[1]):
            raise AssertionError(f'conv2d_same_f32_bwd dw at {shape} '
                                 f'differs without dx')
        log(f'f32 entry {layer} ({cin} -> {cout}), device ms (kernel, cuDNN '
            f'f32 TF32 off, bound, share): ' + '; '.join(
                f'{key} {v[0]:.4f}, {v[1]:.4f}, {v[2]:.4f}, '
                f'{v[2] / v[0]:.2f}' for key, v in row.items()))
        rows[layer] = row
        del x, gy, dx, dw, ref_dx, ref_dw, xn, gyn
        torch.cuda.empty_cache()
    log('f32 entry layers (JSON, device ms: kernel, cuDNN, bound): '
        + json.dumps(rows))


def check_f32_off_tile_layers(records, randn):
    """Phase 15d at ``F32_OFF_TILE_LAYERS`` (B = 32 ten-second clips): 14b's
    seven 3x3 layers at F = 40, 20, 10 and 5 in f32, on the 3xTF32 pair's
    tiles of rows x W pixels (120 at F = 40, 125 at F = 5), and a layer at
    Cout = 10 (padded to 16 for the forward and dw, its dx from 10
    channels on the entry kernels). Per layer: each pass's design
    (asserted, :func:`_assert_f32_layer`); the forward, dx and dw against
    the plain versions (2e-5 of the largest entry forward and dx, 1e-4 for
    dw); dw equal in every bit on a rerun and without dx; each pass's
    device time (torch.profiler: the f32 kernels alone, the weights' split
    with the GEMM, the dw with its reduce; the wrappers' glue, the channel
    pad and narrowing, printed apart) beside its bound (3 TF32 products at
    495 TFLOP/s per f32 product, or bytes) and cuDNN's f32 call with TF32
    off, into ``records['conv2d_same_f32']`` and
    ``records['conv2d_same_f32_bwd']`` (label 'widths'); then the seven
    14b layers' sums, forward and backward (dx + dw), beside cuDNN's and
    the bound."""
    from pb_sed_tpu_torch.ops.kernels.conv import (conv2d_same_f32,
                                                   conv2d_same_f32_bwd,
                                                   conv2d_same_f32_bwd_plain,
                                                   conv2d_same_f32_plain)
    from pb_sed_tpu_torch.ops.kernels.functions import full_f32

    def in_f32(call):
        with full_f32():
            return call()

    def parts(fn, reps=5):
        """Device ms per call of ``fn()`` by part, from one profile:
        'gemm' and 'dw' (``F32_KERNELS``), 'glue' every other kernel."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            found = profile_kernels(lambda: [fn() for _ in range(reps)])
            if found:
                out = dict.fromkeys(('gemm', 'dw', 'glue'), 0.)
                for ms, key, _ in found:
                    part = next((name for name, keys in F32_KERNELS.items()
                                 if any(k in key for k in keys)), 'glue')
                    out[part] += ms / reps
                return out
        raise AssertionError('the profiler recorded no device kernel in '
                             'three tries')

    rows = {}
    for layer, f, cin, cout in F32_OFF_TILE_LAYERS:
        _assert_f32_layer('15d', layer, f, cin, cout)
        x = randn(BATCH, FRAMES, f, cin)
        w = randn(3, 3, cin, cout, scale=(9 * cin) ** -.5)
        bias = randn(cout, scale=.1)
        gy = randn(BATCH, FRAMES, f, cout, scale=1e-3)
        p = BATCH * FRAMES * f
        shape = (layer, BATCH, FRAMES, f, cin, cout)
        xn, gyn = _nchw(x), _nchw(gy)
        wn = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        work = _f32_pass_work(p, cin, cout)
        row = {}
        got, ref = conv2d_same_f32(x, w, bias), conv2d_same_f32_plain(
            x, w, bias)
        fwd = parts(lambda: conv2d_same_f32(x, w, bias))
        lib = device_ms(lambda: in_f32(lambda: F.conv2d(xn, wn, bias,
                                                        padding=1)))
        _check('conv2d_same_f32', shape, got, ref,
               2e-5 * float(ref.abs().max()), fwd['gemm'],
               device_ms(lambda: conv2d_same_f32_plain(x, w, bias), reps=2),
               records['conv2d_same_f32'], 'widths', lib, work)
        row['fwd'] = [fwd['gemm'], lib, work[0], fwd['glue']]
        del got, ref
        dx, dw = conv2d_same_f32_bwd(x, w, gy)
        ref_dx, ref_dw = conv2d_same_f32_bwd_plain(x, w, gy)
        plain_ms = device_ms(lambda: conv2d_same_f32_bwd_plain(x, w, gy),
                             reps=2)
        # dx and dw from one profile of the backward (its glue, the pad,
        # the narrowing and the weight flip, beside dx)
        bwd = parts(lambda: conv2d_same_f32_bwd(x, w, gy))
        for name, got, ref, gate in (('dx', dx, ref_dx, 2e-5),
                                     ('dw', dw, ref_dw, 1e-4)):
            keep = name == 'dx'
            ms = bwd['gemm' if keep else 'dw']
            glue = bwd['glue'] if keep else 0.
            lib = device_ms(lambda: in_f32(
                lambda: torch.ops.aten.convolution_backward(
                    gyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False,
                    [0, 0], 1, [keep, not keep, False])))
            # the plain backward is timed whole, once (beside dx)
            _check(f'conv2d_same_f32_bwd {name}', shape, got, ref,
                   gate * float(ref.abs().max()), ms,
                   plain_ms if keep else 0.,
                   records['conv2d_same_f32_bwd'], 'widths', lib, work)
            row[name] = [ms, lib, work[0], glue]
        if not torch.equal(dw, conv2d_same_f32_bwd(x, w, gy)[1]):
            raise AssertionError(f'conv2d_same_f32_bwd dw at {shape}: a '
                                 f'second run differs')
        if not torch.equal(dw, conv2d_same_f32_bwd(x, w, gy,
                                                   need_dx=False)[1]):
            raise AssertionError(f'conv2d_same_f32_bwd dw at {shape} '
                                 f'differs without dx')
        log(f'f32 off-tile {layer} ({f}, {cin} -> {cout}), device ms '
            f'(kernel, cuDNN f32 TF32 off, bound, share; glue): ' + '; '.join(
                f'{key} {v[0]:.4f}, {v[1]:.4f}, {v[2]:.4f}, '
                f'{v[2] / v[0]:.2f}; {v[3]:.4f}' for key, v in row.items()))
        rows[layer] = row
        del x, gy, dx, dw, ref_dx, ref_dw, xn, gyn
        torch.cuda.empty_cache()
    seven = [rows[name] for name, *_ in TOWER_14B_LAYERS[1:]]
    sums = {key: [sum(r[key][i] for r in seven) for i in range(3)]
            for key in ('fwd', 'dx', 'dw')}
    bwd = [sums['dx'][i] + sums['dw'][i] for i in range(3)]
    log(f'f32 14b L2-L14 summed, device ms: forward {sums["fwd"][0]:.4f} '
        f'(cuDNN f32 {sums["fwd"][1]:.4f}, bound {sums["fwd"][2]:.4f}, '
        f'share {sums["fwd"][2] / sums["fwd"][0]:.3f}); backward '
        f'{bwd[0]:.4f} = dx {sums["dx"][0]:.4f} + dw {sums["dw"][0]:.4f} '
        f'(cuDNN f32 dgrad + wgrad {bwd[1]:.4f}, bound {bwd[2]:.4f}, share '
        f'{bwd[2] / bwd[0]:.3f})')
    log('f32 off-tile layers (JSON, device ms: kernel, cuDNN, bound, glue): '
        + json.dumps(rows))


def _padded_width_choice(randn):
    """Why H = 200 runs as 256 at the training shape: the forward at
    (2, 32, 500) of the row-tiled kernel at 224 (the next multiple of 32)
    against the cluster design at 256 (``scripts/perf/gru_designs.py``'s
    ``scan_as``, which runs the design it is told), both on H = 200's
    operands padded exactly, each within the GRU ceiling of the plain
    version at 200."""
    import importlib.util
    path = Path(__file__).resolve().parent / 'scripts/perf/gru_designs.py'
    spec = importlib.util.spec_from_file_location('gru_designs', path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    from pb_sed_tpu_torch.ops.kernels.gru import pad_hidden, unpad_hidden
    d, b, t, h = 2, BATCH, FRAMES, PADDED_HIDDEN
    xw = randn(d, b, t, 3 * h).to(torch.bfloat16)
    w_hh = randn(d, h, 3 * h, scale=h ** -.5)
    b_hh = randn(d, 3 * h, scale=.1)
    h0 = torch.zeros(d, b, h, device=xw.device)
    ref = gru_scan_plain(xw, w_hh, b_hh, h0)
    times = {}
    for design, hp in (('row_tiled', 224), ('cluster', 256)):
        args = pad_hidden(xw, w_hh.to(torch.bfloat16), b_hh, h0, hp=hp)
        y = unpad_hidden(h, y=probe.scan_as(design, *args))[0]
        err = float((y - ref).abs().max())
        if not err <= 5.3e-3:
            raise AssertionError(f'H = 200 as {hp} ({design}) differs from '
                                 f'the plain version by {err}')
        times[f'{design}_{hp}_ms'] = cuda_ms(
            lambda: probe.scan_as(design, *args), reps=5)
    log(f'H = 200 at (2, 32, 500): ' + json.dumps(times) + '; the wrapper '
        f'runs {gru_designs(d, b, t, h)["fwd"]["hidden"]}')


def _padded_wide_width(randn):
    """What padding costs above 512, where the cluster design takes H a
    multiple of 256: the forward and backward wrappers at (2, 32, 500) at
    H = 600 (run as 768) beside H = 768 itself, each forward within the
    GRU ceiling of the plain version at its own H."""
    times = {}
    for h in (PADDED_WIDE_HIDDEN, WIDE_HIDDEN):
        d, b, t = 2, BATCH, FRAMES
        xw = randn(d, b, t, 3 * h).to(torch.bfloat16)
        w_hh = randn(d, h, 3 * h, scale=h ** -.5)
        b_hh = randn(d, 3 * h, scale=.1)
        h0 = torch.zeros(d, b, h, device=xw.device)
        y = gru_scan(xw, w_hh, b_hh, h0)
        err = float((y - gru_scan_plain(xw, w_hh, b_hh, h0)).abs().max())
        if not err <= 5.3e-3:
            raise AssertionError(f'gru_scan at H = {h} differs from the '
                                 f'plain version by {err}')
        g = randn(d, b, t, h, scale=1e-2)
        times[h] = {
            'runs_as': gru_designs(d, b, t, h)['fwd']['hidden'],
            'fwd_ms': cuda_ms(lambda: gru_scan(xw, w_hh, b_hh, h0), reps=5),
            'bwd_ms': cuda_ms(lambda: gru_scan_bwd(xw, w_hh, b_hh, h0, y, g),
                              reps=3)}
        del xw, y, g
    log(f'H = {PADDED_WIDE_HIDDEN} beside H = {WIDE_HIDDEN} at (2, 32, 500), '
        'wrappers: ' + json.dumps(times))


def _width_config(name, augment=True):
    """Phase 15's configurations at full width: '15a' the shallow FBCRNN
    with ``compute_dtype='float32'`` in both towers and both heads' output
    nets; '15b' the shallow FBCRNN with both heads at ``hidden_size`` 768
    (the paired D = 2 recurrence above 512); '15c' the
    tag-conditioned shallow BiCRNN at ``hidden_size`` 200 (run as 256);
    '15e' that BiCRNN at the recipe's widths with
    ``compute_dtype='float32'`` in both towers and the output net; '15f'
    14b's configuration (:func:`_tower_config`) with
    ``compute_dtype='float32'`` in both towers and both heads' output
    nets."""
    if name == '15f':
        config = _tower_config('14b', augment=augment)
        for tower in F32_PATHS:
            config['cnn'][tower]['compute_dtype'] = 'float32'
        config['rnn_fwd']['output_net']['compute_dtype'] = 'float32'
        return config
    if name in ('15c', '15e'):
        config = _strong_config(augment=augment)
        if name == '15c':
            config['rnn']['rnn']['hidden_size'] = PADDED_HIDDEN
        else:
            for tower in F32_PATHS:
                config['cnn'][tower]['compute_dtype'] = 'float32'
            config['rnn']['output_net']['compute_dtype'] = 'float32'
        return config
    config = _config('shallow', 10, augment=augment)
    if name == '15a':
        for tower in F32_PATHS:
            config['cnn'][tower]['compute_dtype'] = 'float32'
        config['rnn_fwd']['output_net']['compute_dtype'] = 'float32'
    else:
        config['rnn_fwd']['rnn']['hidden_size'] = WIDE_HIDDEN
    return config


def _assert_f32_designs(label, layers):
    """Log the f32 conv's design of each pass at ``layers`` and assert
    the rule (:func:`f32_designs_wanted`: the entry kernels at Cin < 16
    and for a dx from fewer than 16 channels, 3xTF32 elsewhere), every
    kernel whole."""
    for layer, f, cin, cout in layers:
        _assert_f32_layer(label, layer, f, cin, cout)


def phase_widths(earlier):
    """Phase 15. 15a: the f32 shallow FBCRNN serves 3 x 32 clips by
    tagging and SED 51/1 (against the CPU) and trains 8 steps; 15b: the
    shallow FBCRNN with both heads at H = 768 does the same on the GRU
    pair's cluster design above 512; 15c: the tag-conditioned BiCRNN at
    H = 200 tags 3 x 32 clips and trains 8 steps; 15e: the
    tag-conditioned BiCRNN with f32 towers and output net (its entry
    layer, Cin = 11, on the f32 entry kernels) tags 32 clips and trains 4
    steps; 15f: 14b's deep tower at 40 mel bins with f32 towers and output
    nets (its 3x3 layers at F = 40 ... 5 on the 3xTF32 pair's rows x W
    tiles, L0 on the entry kernels) tags 32 clips and trains 4 steps.
    Each training run passes the card-vs-CPU step; each path's launch
    counters are read. Returns (launches by path, the measurements),
    printed beside ``earlier`` (phases 3-4, and 14b's bf16 run for
    15f)."""
    from pb_sed_tpu_torch.models import base
    launches, out = {}, {}
    f32_path = F32 + F32_ENTRY + ('maxpool2d', 'maxpool2d_bwd', 'gru_scan',
                                  'gru_scan_bwd')
    cases = [('15a', f32_path, 10, False),
             ('15b', SHALLOW + WIDE, 10, False),
             ('15c', SHALLOW + PADDED_GRU, 10, True),
             ('15e', f32_path, 10, True),
             ('15f', f32_path + CROSSED, 527, False)]
    for name, kernels, k, strong in cases:
        config = _width_config(name)
        flat = _random_flat(config, strong=strong)
        model = _model(config, flat, 'cuda', strong=strong)
        module = model.module
        if name == '15a':
            dtypes = {module.cnn.cnn_2d.conv_1.dtype,
                      module.cnn.cnn_1d.conv_1.dtype,
                      module.rnn_fwd.output_net.conv_0.dtype,
                      module.rnn_bwd.output_net.conv_0.dtype}
            if dtypes != {torch.float32}:
                raise AssertionError(f'15a: layers in {dtypes}')
            # the launches counted below run these designs: 3xTF32 at
            # L1-L8, the entry kernels at L0, whose backward runs its dx
            # too: the pre-activation norm_0's learnable scale and shift
            # sit before it (a layer runs no dx only where nothing
            # upstream needs a gradient)
            _assert_f32_designs(name, CONV_LAYERS)
        if name == '15e':
            dtypes = {module.cnn.cnn_2d.conv_0.dtype,
                      module.cnn.cnn_1d.conv_0.dtype,
                      module.rnn.output_net.conv_0.dtype}
            if dtypes != {torch.float32}:
                raise AssertionError(f'15e: layers in {dtypes}')
            _assert_f32_designs(name, STRONG_CONV_LAYERS)
        if name == '15f':
            dtypes = {module.cnn.cnn_2d.conv_2.dtype,
                      module.cnn.cnn_1d.conv_1.dtype,
                      module.rnn_fwd.output_net.conv_0.dtype,
                      module.rnn_bwd.output_net.conv_0.dtype}
            if dtypes != {torch.float32}:
                raise AssertionError(f'15f: layers in {dtypes}')
            _assert_f32_designs(name, TOWER_14B_LAYERS)
        head = module.rnn.rnn if strong else module.rnn_fwd.rnn
        log(f'{name}: {model.num_parameters()} parameters, GRU hidden size '
            f'{head.hidden_size}, designs at (2, 32, 500): '
            + json.dumps({key: None if v is None else v['design']
                          for key, v in gru_designs(
                              2, BATCH, FRAMES, head.hidden_size).items()}))
        batches = _synthetic_batches(module.feature_extractor.stft)
        if strong:
            batches = _tagged(batches, seed=9)
            methods = [('tagging', base.tagging, {})]
        elif name == '15f':
            methods = _methods(base)[:1]
        else:
            methods = [_methods(base)[i] for i in (0, 2)]
        if name in ('15e', '15f'):
            batches = batches[1:2]     # 32 clips
        forward = tuple(kernel for kernel in kernels if 'bwd' not in kernel)
        stats = out.setdefault(f'{name}_serving', {})
        results, launches[f'widths_{name}_serving'] = _serve(
            model, methods, batches, k, name, forward, low=0. if strong
            else 1e-5, stats=stats)
        _agree_with_cpu(_model(config, flat, strong=strong), methods,
                        results, batches[min(1, len(batches) - 1)])
        del model, module, head
        torch.cuda.empty_cache()
        launches[f'widths_{name}_training'], out[f'{name}_training'] = \
            _train_towers(
                lambda augment, n=name, s=strong: _model(
                    _width_config(n, augment), flat, strong=s),
                k, kernels, name, strong=strong, gru_order=True,
                steps=4 if name in ('15e', '15f') else TRAIN_STEPS)
    log('phase 15 beside phases 3-4 (host clock, B = 32): tagging clips/s '
        + ', '.join(f'{key} {out[key]["tagging_clips_per_s"]:.1f}'
                    for key in out if key.endswith('_serving'))
        + f' vs shallow (phase 3) '
        f'{earlier["serving"]["tagging_clips_per_s"]:.1f}; training steps/s '
        + ', '.join(f'{key} {out[key]["steps_per_s"]:.3f}' for key in out
                    if key.endswith('_training'))
        + f' vs shallow (phase 4) {earlier["shallow"]["steps_per_s"]:.3f}; '
        'peak GiB ' + ', '.join(f'{key} {value["peak_gib"]:.2f}'
                                for key, value in out.items())
        + f' vs shallow serving {earlier["serving"]["peak_gib"]:.2f}, '
        f'training {earlier["shallow"]["peak_gib"]:.2f}')
    bf16 = earlier['towers']
    log('15f (f32) beside 14b (bf16), host clock, B = 32: tagging clips/s '
        f'{out["15f_serving"]["tagging_clips_per_s"]:.1f} vs '
        f'{bf16["14b_serving"]["tagging_clips_per_s"]:.1f}; training '
        f'steps/s {out["15f_training"]["steps_per_s"]:.3f} vs '
        f'{bf16["14b_training"]["steps_per_s"]:.3f}, clips/s '
        f'{out["15f_training"]["clips_per_s"]:.1f} vs '
        f'{bf16["14b_training"]["clips_per_s"]:.1f}; peak GiB serving '
        f'{out["15f_serving"]["peak_gib"]:.2f} vs '
        f'{bf16["14b_serving"]["peak_gib"]:.2f}, training '
        f'{out["15f_training"]["peak_gib"]:.2f} vs '
        f'{bf16["14b_training"]["peak_gib"]:.2f}')
    return launches, out


def _descendants():
    """{pid: command line} of every live process below this one, from
    ``/proc``."""
    parents = {}
    for entry in Path('/proc').iterdir():
        if entry.name.isdigit():
            try:
                stat = (entry / 'stat').read_text()
            except OSError:                        # it ended meanwhile
                continue
            # pid (comm) state ppid ...: comm may hold spaces and parentheses
            parents[int(entry.name)] = int(stat.rsplit(')', 1)[1].split()[1])
    found, frontier = {}, [os.getpid()]
    while frontier:
        pid = frontier.pop()
        for child, parent in parents.items():
            if parent == pid and child not in found:
                try:
                    found[child] = (Path(f'/proc/{child}/cmdline').read_bytes()
                                    .replace(b'\0', b' ').decode()[:120])
                except OSError:
                    found[child] = '?'
                frontier.append(child)
    return found


def stop_processes():
    """Stop every process this run started before it ends: the evaluation
    pools' forkserver and resource tracker (which would otherwise exit only
    after this process has), then any other process below this one
    (logged by pid and command line, terminated, killed after 10 s)."""
    import multiprocessing
    import signal
    from pb_sed_tpu_torch.evaluation import parallel
    parallel.stop_pools()
    multiprocessing.active_children()               # joins finished ones
    left = _descendants()
    if not left:
        return
    log(f'processes left at the end, stopped: {left}')
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + 10.
        while time.monotonic() < deadline:
            for pid in left:                         # reap our own children
                with contextlib.suppress(ChildProcessError):
                    os.waitpid(pid, os.WNOHANG)
            if not _descendants():
                return
            time.sleep(.1)


def main():
    start = time.perf_counter()
    try:
        card, kernels = run()
    finally:
        stop_processes()
    log(f'chip_smoke.py ran {time.perf_counter() - start:.1f} s '
        f'(the kernels\' build included)')
    print(card)                           # nvidia-smi name, power.limit
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def run():
    card = phase_card()
    records = {name: new_record() for name in KERNELS}
    log('TF32 off for cuDNN and cuBLAS (plain versions in full f32)')
    build.reset_launches()
    check_kernels(records, 'shallow', 0, CONV_LAYERS, POOLS, GRU_SHAPES,
                  fused=[name for name, *_ in CONV_LAYERS[1:]])
    check_chain_gru_shapes(records)
    check_strong_shapes(records)
    check_kernels(records, 'deep', 2, DEEP_CONV_LAYERS, DEEP_POOLS,
                  DEEP_GRU_SHAPES, DEEP_CROSSINGS,
                  fused=[name for name, *_ in DEEP_CONV_LAYERS[1:]])
    kernel_phase = dict(build.LAUNCHES)
    log('conv layers: ' + json.dumps(CONV_ROWS))
    for name in ('fwd', 'bwd', 'fused_fwd', 'fused_bwd'):
        sums = [sum(r[name][i] for r in CONV_ROWS if name in r
                    and r[name][i] is not None) for i in range(3)]
        log(f'conv {name} summed over both towers: kernel {sums[0]:.3f} ms, '
            f'cuDNN {sums[1]:.3f} ms, bound {sums[2]:.3f} ms')
    log_redesigned(records)
    check_1x1()
    build.reset_launches()
    check_tower_kernels(records)
    tower_kernel_phase = dict(build.LAUNCHES)
    build.reset_launches()
    check_width_kernels(records)
    width_kernel_phase = dict(build.LAUNCHES)
    serving = {}
    launches = {'shallow_serving': phase_slice(serving)}
    launches['shallow_training'], in_memory = phase_training('shallow')
    launches['deep_serving'], unfused_tags = phase_deep_serving()
    launches['deep_training'], unfused = phase_training('deep')
    launches['deep_fuse_bn_serving'] = phase_fuse_bn_serving(unfused_tags)
    launches['deep_fuse_bn_training'], fused = phase_training('deep_fuse_bn')
    log('deep training, unfused vs fuse_bn (B=32, steps 3-8, host clock): '
        + ', '.join(f'{key} {unfused[key]:.3f} vs {fused[key]:.3f}'
                    for key in ('steps_per_s', 'clips_per_s', 'peak_gib')))
    (launches['shallow_fuse_bn_serving'],
     launches['shallow_fuse_bn_training']) = phase_shallow_fuse_bn()
    with tempfile.TemporaryDirectory() as tmp, recording_gru_shapes():
        launches['cli_training'], cli_metrics, runs = phase_cli_training(
            in_memory, Path(tmp))
        launches['tuning_chain'], chain, weak_hp_dir = phase_tuning_chain(
            Path(tmp), runs)
        log('tuning chain (JSON): ' + json.dumps(chain))
        strong = phase_strong(in_memory)
        launches.update(strong.pop('launches'))
        strong_chain = phase_strong_chain(Path(tmp), weak_hp_dir,
                                          strong['training'])
        launches.update(strong_chain.pop('launches'))
    log('strong phase (JSON): ' + json.dumps(strong))
    log('strong chain (JSON): ' + json.dumps(strong_chain))
    ensemble = phase_stacked_ensemble(records)
    ensemble['gru_against_plain'] = check_stacked_gru_shapes(records)
    launches.update(ensemble.pop('launches'))
    log('stacked ensemble (JSON): ' + json.dumps(ensemble))
    with tempfile.TemporaryDirectory() as tmp:
        transformer_launches, transformer = phase_transformer(tmp)
    launches.update(transformer_launches)
    log('transformer phase (JSON): ' + json.dumps(transformer))
    with tempfile.TemporaryDirectory() as tmp:
        prep_launches, prep = phase_data_prep(Path(tmp), card, cli_metrics)
    launches.update(prep_launches)
    log('data-preparation phase (JSON): ' + json.dumps(prep))
    mesh_launches, mesh = phase_mesh(card)
    launches.update(mesh_launches)
    log('mesh phase (JSON): ' + json.dumps(mesh))
    tower_launches, towers = phase_towers(
        {'serving': serving, 'shallow': in_memory, 'deep': unfused})
    launches.update(tower_launches)
    log('towers phase (JSON): ' + json.dumps(towers))
    width_launches, widths = phase_widths(
        {'serving': serving, 'shallow': in_memory, 'towers': towers})
    launches.update(width_launches)
    log('widths phase (JSON): ' + json.dumps(widths))
    launches['kernel_phase'] = kernel_phase
    launches['tower_kernel_phase'] = tower_kernel_phase
    launches['width_kernel_phase'] = width_kernel_phase
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
            'ms': _total(rec['shallow_ms'], rec['deep_ms'],
                         rec['towers_ms'], rec['widths_ms']),
            'plain_ms': _total(rec['shallow_plain_ms'],
                               rec['deep_plain_ms'],
                               rec['towers_plain_ms'],
                               rec['widths_plain_ms']),
            'bound_ms': rec['bound_ms'], 'bound_by': side,
            'library_ms': rec['library_ms'],
            **{key: rec[key] for key in (
                'shallow_ms', 'shallow_plain_ms', 'shallow_library_ms',
                'deep_ms', 'deep_plain_ms', 'deep_library_ms', 'towers_ms',
                'towers_plain_ms', 'towers_library_ms', 'widths_ms',
                'widths_plain_ms', 'widths_library_ms')},
            **{key: v for key, v in rec.items()
               if key.startswith('member_')}})
    return card, kernels


if __name__ == '__main__':
    main()
