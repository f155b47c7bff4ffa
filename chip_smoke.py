#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`aclgan_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full width (male2female, random weights from a
seed; InceptionV3 at 299^2), serving (A->B translation), training (D and G
steps at the D1/G2 cadence; the bn / sn discriminators, tpu.remat,
tpu.grad_accum, bf16 moments, a resumed JAX run), evaluation (the test CLIs, IS / CIS / FID,
the classifier fine-tune, the FID curve), the serving stack (buckets,
the exported artifact, the HTTP front), the JPEG decode core, data
parallelism (two ranks on the card, the CLI under torchrun), the
multi-replica Translator, the VGG perceptual loss and spatial (H) sharding
(two ranks at 512^2), through the hand-written CUDA kernels, and fails,
with a non-zero exit, if any phase fails. On the card the train step (on
one device and under an NCCL mesh, data-parallel or a spatial grid),
`sample` and the Translator's served batch run as CUDA graphs (`aclgan_tpu_torch/graphs.py`:
each key's first call eager, then captured, then replayed), so every
phase's launch counts hold for the graphed forms; gloo meshes (phases 23,
27) stay eager:

1. device info (torch/CUDA versions, nvidia-smi name and power limit);
2. build every kernel under aclgan_tpu_torch/csrc with nvcc;
3. K1 (instance-norm forward), both variants (the row on chip over a
   cluster, and streaming), against its plain PyTorch version at the
   serving shapes, phase 27's 512^2 rows, 48 x 40 and odd rows and bases off
   16 bytes, its (mean, rsig) against `instance_norm_stats_plain`, two
   launches bit-equal; timings of the kernel (each variant), the plain
   version and one library call over a Translator batch and over a D+G
   training iteration, each layer's launch plan, and the host's
   microseconds a call through the `aclgan::` op costs against the bare
   wrapper and the wrapper under a device guard;
4. K2 (instance-norm backward), both variants, fed K1's statistics, against
   its plain version without them at the training shapes and phase 3's
   edge cases, with the same timings over one G step;
5. Translator end to end in float32 (TF32 off): 70 requests in 3 batches of
   32, the last padded; 19 K1 launches per batch; uint8 outputs within
   2 LSB of the same Translator on the CPU (plain versions);
6. Translator end to end in bfloat16 (the config's dtype): img/s, peak
   memory, device time by kernel group over one window (torch.profiler),
   and the difference from phase 5's outputs;
7. training in float32 (TF32 off) at 128^2, batch 2: one D+G iteration and
   one D iteration on the card against the same on the CPU (metrics, every
   network's gradients, K1/K2 launch counts);
8. training in bfloat16 at 256^2, batch 16 (the shipped config): iterations/s,
   images/s, peak memory and the graphs' pool, finite losses, device time by
   kernel group over one D+G iteration, and the K1/K2 launches of one D+G
   iteration (its FLOPs are counted in phase 29, where an eager step runs);
9. the train CLI (`aclgan_tpu_torch.cli.train.main`, in process) on the
   shipped config at its own batch of 3, on the synthetic dataset: 40
   iterations with grids at 10/20/30/40 and snapshots at 20/40 (scalars, files,
   grids, K1/K2 launches), then `--resume` to 50 (restored tensors bit-equal to
   the files, records continue at 41); p50 seconds per iteration from the
   CLI's own `Iteration:` lines, without those after a grid or snapshot;
10. the train CLI at batch 16, 30 iterations, with `--profile_dir`: p50
   seconds per iteration, its ratio to phase 8's bare `train_step`, peak
   memory, a non-empty trace holding K1;
11. a dataset: `tools/make_dataset.py --style hard`, 64 train and 64 test
   images a domain at 286^2 (numpy and Pillow, in a subprocess);
12. `cli.train_inception` on it: InceptionV3 (2 classes) at 149^2, batch 32,
   40 Adam steps: steps/s, full-set accuracy, a torchvision-layout `.pt`;
13. `cli.test` in float32 (TF32 off): one 256^2 image, 10 styles; the files,
   19 K1 launches, outputs within 2 LSB of the same CLI on the CPU;
14. `cli.test_batch` (bf16, the config's dtype) on testA, batch 32, 3 styles,
   IS / CIS / FID against testB with phase 12's classifier: the files, 57 K1
   launches a style a batch, finite scores; the scorer's features and
   softmax on 8 images on the card against the CPU; img/s of the CLI and of
   one batch (translation + scoring), the scorer's img/s at batch 32 and
   299^2, the seconds of the 2048^2 scipy sqrtm, peak memory, and the
   device time by kernel group over one batch;
15. `cli.fid_curve`: since the acceptance phase sweeps the same path at the
   same sizes (64 images, 2 styles, 20 bootstrap resamples) over its own
   snapshots, its checks run there (phase 28): rows with the JAX tool's
   keys, finite FIDs and intervals, 19 K1 launches a snapshot a style,
   seconds a snapshot;
16. [bucketed] `BucketedTranslator` (buckets 128/192/256, batch 32, bf16): 96
   requests with short sides over 100-320 and explicit styles; each output
   within 1 LSB of a plain Translator at its bucket; `compiled_shapes()` 3
   after `warmup()` and after repeated traffic; 19 K1 launches a device
   batch; img/s (host clock, resize and crop included);
17. [export] `export_translator` at batch 32 on the card (seconds, 19 op
   nodes), the artifact's MB, `ExportedTranslator`: 70 requests within
   1 LSB of phase 6, 19 K1 launches a batch, img/s against the live
   Translator in turns (live, exported, exported, live);
18. [http] `serving_http.make_server` over a Translator at batch 16 with a
   5 ms window on 127.0.0.1: closed-loop clients (a spawned process) POST
   256^2 JPEGs for 3 s at concurrency 1, 8, 32 and 48, then 8 over `--artifact`
   (exported by `cli.export` at batch 16): img/s, p50 / p99 latency, the
   mean coalesced batch, 0 errors, 19 K1 launches a device batch;
19. [variants_f32] phase 7's cut (f32, 128^2, batch 2), one D+G iteration on
   the card against the CPU for dis sn + nsgan, dis bn (batch 4), tpu.remat
   all + grad_accum 2 (batch 4) and bf16 moments: metrics (rel 1e-3), the five
   networks' gradients (rel-L2 1e-2), u / v and running stats (rel 1e-3),
   (K1, K2) 98/49 a D+G iteration, 294/98 under remat all x accum 2;
20. [remat_bf16] the shipped config (bf16, 256^2) at batch 16 under tpu.remat
   none / decode / encode / all: it/s (p50 of windows, CUDA events), peak
   memory, (K1, K2) of a D+G iteration (98 / 114 / 131 / 147, and 49);
   batch 64 under remat all and under grad_accum 4; bf16 moments at 16: it/s
   and the optimizer's bytes against remat none's float32 moments;
21. [jax_resume] a bf16 run at batch 16 with EMA written as a JAX-layout set
   (`save_jax_checkpoint`), resumed bit-equal (weights, EMA, moments, step),
   the next step on injected z against the writer's (phase 7's tolerances);
   `cli.train --resume` on the set; `cli.convert` of its gen/dis msgpack and
   of a port `.pt` snapshot; the import resumed in the CLI with fresh moments;
22. [native] the port's libjpeg decode core built from `native/` into
   `aclgan_tpu_torch/_build/` (a failed build fails the phase where
   `/usr/include/jpeglib.h` exists); phase 11's 64 trainA JPEGs through the
   loader at batch 16 with 1 worker and the config's workers, with the core
   (when built) and through Pillow: img/s; the train CLI at batch 16 for 30 iterations on
   that folder: p50 s per iteration against phase 10, (K1, K2);
23. [dp_two_ranks] two processes on the one card joined over gloo with CUDA
   tensors: one D+G iteration at phase 7's cut (f32, 128^2, global batch 4,
   2 a rank) for dis in and dis bn on injected global z, against one process
   at batch 4: metrics (rel 1e-4), the five networks' updated params (rel-L2
   1e-3; their gradients reported), bn running stats (rel 1e-3 beyond the
   0.2*lr slack), the ranks' params equal, (K1, K2) on each rank;
24. [ddp_cli] `python -m torch.distributed.run --nproc_per_node 1` of the
   train CLI (`chip_smoke.py --torchrun-cli`, which runs `cli.train.main`
   and writes its counters; `torch_ranks.torchrun`, one deadline that dumps
   every rank's stack) with `tpu.distributed: true` (NCCL: the steps
   replay CUDA graphs with their all-reduces inside) on the shipped config,
   synthetic, batch 16, bf16: 30 iterations traced at 10..14 with grids at
   10, 20, 30, then `--resume` to 35: p50 s per iteration against phase 10,
   the form that ran, (K1, K2) over the run and under replay against the
   cadence, the graphs destroyed before the group, the trace's K1 / K2
   events (held by `_hold_trace`), the records, grids and snapshot files;
25. [devices] `Translator(devices=-1)`: outputs equal to phase 6's; devices=2
   raises the JAX message with one card visible;
26. [vgg] `compute_vgg_loss` at 256^2, batch 16, f32: loss and image
   gradients against the plain instance norm (rel 1e-4), ms a loss, (K1, K2)
   a loss (2, 2);
27. [spatial_two_ranks] two processes on the one card over gloo with CUDA
   tensors, a 1 x 2 (data, spatial) grid, male2female full width at 512^2,
   global batch 2, f32 with TF32 off: one sharded translate (max |diff| 1e-4)
   and one D+G iteration (metrics rel 1e-4, params rel-L2 1e-3, the ranks
   equal) against one process at 512^2, batch 2; each rank's (K1, K2, K1m,
   K1a, K2m, K2a) (0, 0, 19, 19, 0, 0) a translate and (0, 0, 98, 98, 49, 49)
   a D+G iteration; each rank's peak memory against the one process, the
   steps' seconds and all-reduce counts; then K1m, K1a, K2m and K2a against
   their plain versions at a rank's shapes (two launches bit-equal), K1m and
   K2m also on a ragged row, bases off 16 bytes and 262,144-element rows;
   K1m's and K2m's host microseconds a call against their library calls';
   all four timed in bf16 over a rank's iteration (CUDA events, and device
   time a launch from torch.profiler), beside their bound and one library
   call each;
28. [acceptance_mini] `tools/torch_synthfaces_hard.py --smoke` on phase 11's
   dataset and phase 12's classifier: the train CLI on
   `configs/synthfaces_hard.yaml` (EMA 0.999, batch 16, bf16) for 20
   iterations, then `--resume` to 40, snapshots at 20 and 40, each call
   followed by the gen and the ema FID curves (n 64, 2 styles, 20 resamples;
   the second sweep of each resumes with `--start_after 20`); the (K1, K2)
   launches of each call against the count the D1/G2 cadence gives, finite
   records, every gen / dis / ema snapshot; `report` refusing the recorded
   curves (n 500) and taking gen against ema, with the selected snapshot's
   grid; then one f32 D+G iteration and one D iteration with EMA at 128^2,
   batch 2 on the card against the CPU: the EMA after the G step equal to
   d * EMA + (1 - d) * the stepped weights in float32 within 1e-2 of
   (1 - d) * max |step| and off the form with the weights from before the
   step by at least half of that, unmoved by the D iteration, and its
   movement within the parity tests' movement bar (rel-L2 0.05) of the CPU's;
   and the CLI's host-heap release: in each train call every run of grid or
   snapshot writes is followed by one `release_host_heap` and no release
   comes without a write (the MiB each gives back logged, the heap released
   before the call), and on this host 384 MiB of 6 MiB blocks (glibc's mmap
   threshold raised by a freed 16 MiB block, the heap then released, each
   block pinned by a small live one after it) add at least 90% of their
   size to VmRSS, stay resident after their frees (at most half of that
   given back) until the release gives back at least half of it;
29. [graphs] the CUDA graphs against the eager forms: the Translator's
   outputs over phase 5's requests (f32, TF32 off: bit-equal) and six f32
   training iterations at 128^2, batch 2 (D+G, D, step_increment 2, a StepLR
   boundary, EMA: metrics, the five networks, moments, EMA, z stream, against
   three eager runs' spread, reported, then one D+G iteration from one state,
   replayed and eager in three copies: pre-update metrics bit-equal, the
   replayed state within 2x the widest distance between two eager copies;
   `graph_train_check`); the bare bf16 step at 256^2, batch 3 and 16,
   graphed and eager in turns (s an iteration, the host's s to issue one, the
   device's idle share over a traced D+G + D, peak memory, the graphs' pool,
   capture seconds, (K1, K2) against the cadence's count, TFLOP/s from an
   eager step's FLOPs); phase 9's CLI s an iteration; the Translator in bf16
   at 256^2, batch 1, 8 and 32, graphed and eager (img/s, p50 ms a batch,
   the host's us a call, capture seconds, pool); `sample` in f32 at 256^2,
   4 rows, three calls (eager, captured, replayed) against the eager model:
   bit-equal, 57 K1 a call, its capture bytes;
30. [mesh_graphs] the train step under an NCCL mesh as a CUDA graph: a
   `DataMesh` of one rank in a spawned process, the bare bf16 step at batch
   3 (and on two or more cards 16, and phase 27's f32 step at 512^2,
   batch 2), graphed and eager (s an iteration, host s, idle share, peak,
   pool, launches against the cadence). On two or more cards also (on one,
   it logs that this part needs more cards): two NCCL ranks run the
   data-parallel D+G step for dis in and then dis bn in one process pair
   (phase 23's cut; each replayed iteration held to its eager twin at
   phase 23's bars and to one process at `MESH_ALONE_BARS`, the ranks
   bit-equal); the 1 x 2 and, on four cards, the 2 x 2 spatial grid at
   that cut, graphed (dis bn; the same holds, and the replayed state within
   2x the widest pair of three eager copies, phase 29's rule; the split
   kernels' launches equal to eager's, K1 and K2 none); then at 2 and at
   4 ranks where the host has the cards, the bare step at global batch 16
   and the spatial step at 512^2 on a 1 x world grid, each graphed and
   eager against one card (the split kernels' device ms and events over a
   traced D+G + D), and phase 24's train CLI under torchrun at that world
   (`phase_ddp_cli`, every rank held to the cadence). Every spawn and
   torchrun runs under one deadline that dumps each rank's stack and
   collective log;
31. K1's and K2's device time a launch at each layer of phases 3-4's mixes
   (torch.profiler, or CUDA events behind a queued busy kernel where the
   profiler loses the kernels) beside the library call's; run last so that
   no profiler session precedes the phases that trace;
32. one JSON line listing every kernel;
33. last line: {"ok": true, "device": {...}}.

Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "male2female.yaml"
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
MAIN_SHAPES = [(32, 64, 256, 256), (32, 128, 128, 128), (32, 256, 64, 64)]
TOL = {torch.float32: 1e-4,    # 65,536-term sums taken in another order
       torch.bfloat16: 0.05}   # one bf16 rounding of the output (tests/test_pallas.py)
LAUNCHES_PER_BATCH = 19        # 11 IN (content encoder) + 8 AdaIN (decoder)
N_REQUESTS = 70
BATCH = 32
# per training step: 3 content encodes (11 IN each) + 2 decodes (8 AdaIN each)
K1_PER_STEP = 49
K2_PER_G_STEP = 49             # the backward of every K1 of the G step
TRAIN_BATCH = 16               # bench.py's training batch
BIG_BATCH = 64                 # a batch only tpu.remat or tpu.grad_accum fits (phase 20)


def _encode_mix(n, h=256, w=256):
    """The content encoder's IN layers at batch n on h x w images (male2female;
    256^2 unless said)."""
    return [((n, 64, h, w), False, 1), ((n, 128, h // 2, w // 2), False, 1),
            ((n, 256, h // 4, w // 4), False, 9)]


def _decode_mix(n, h=256, w=256):
    """The decoder's AdaIN layers at batch n."""
    return [((n, 256, h // 4, w // 4), True, 8)]


def _g_step_mix(b, h=256, w=256):
    """Instance-norm layers of one G step at batch b: gen_AB encodes x_a||x_b,
    gen_BA encodes x_a and x_B_fake, gen_AB decodes 2b, gen_BA decodes 3b."""
    return (_encode_mix(2 * b, h, w) + _encode_mix(b, h, w) + _encode_mix(b, h, w)
            + _decode_mix(2 * b, h, w) + _decode_mix(3 * b, h, w))


def _d_step_mix(b, h=256, w=256):
    """Instance-norm layers of one D step at batch b (no x_b, no self-recons)."""
    return _encode_mix(b, h, w) * 3 + _decode_mix(b, h, w) + _decode_mix(2 * b, h, w)


TRAIN_SHAPES = [(32, 64, 256, 256), (32, 128, 128, 128), (32, 256, 64, 64)]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _ptxas_report(text):
    """[(kernel, registers, bytes of spill stores and loads)] from nvcc's
    -Xptxas=-v output, names demangled by c++filt where it exists."""
    rows, name, spill = [], None, 0
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            rows.append([name, int(m.group(1)), spill])
            name, spill = None, 0
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, check=True).stdout.split("\n")
        for r, n in zip(rows, names):
            r[0] = n.replace("(anonymous namespace)::", "")
    except (OSError, subprocess.CalledProcessError):  # no c++filt: mangled names
        pass
    return rows


def phase_build():
    from aclgan_tpu_torch.ops.kernels import build

    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    t0 = time.time()
    logs = build.build_all(sources)
    log(f"[build] {sources} in {time.time() - t0:.2f} s")
    for src, text in logs.items():
        rows = _ptxas_report(text)
        for name, regs, spill in rows:
            log(f"[build] {src}: {name[:120]}: {regs} registers, {spill} bytes spilled")
        log(f"[build] {src}: {len(rows)} kernels, {sum(r[2] for r in rows)} bytes of spill "
            f"stores and loads in all")


def _time_mix(tag, mix, make, run, plain, library, nbytes, flops_per_element, extra=None,
              describe=None):
    """Kernel, plain and library ms of a list of (shape, affine, count) layers,
    each shape timed once and counted `count` times; also the bytes bound.
    `extra` ({label: fn}) times more calls of the same arguments (another
    variant of the kernel) into `<label>_ms`; `describe(*args)` adds a note
    (the launch plan) to each layer's line."""
    extra = extra or {}
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0,
               **{f"{k}_ms": 0.0 for k in extra})
    for shape, affine, count in mix:
        args = make(shape, affine)
        ms, plain_ms, library_ms = (time_ms(lambda f=f: f(*args))
                                    for f in (run, plain, library))
        more = {f"{k}_ms": time_ms(lambda f=f: f(*args)) for k, f in extra.items()}
        b = nbytes(shape, affine)
        flops = flops_per_element * math.prod(shape)
        bound = max(b / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        log(f"[kernel] {tag} bf16 {shape} affine={affine} x{count}: kernel {ms:.4f} ms, "
            + "".join(f"{k[:-3]} {v:.4f} ms, " for k, v in more.items())
            + f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound:.4f} ms, "
            f"{b / ms / 1e6:.0f} GB/s" + (f"; {describe(*args)}" if describe else ""))
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("bytes", b), ("flops", flops), *more.items()):
            tot[key] += count * val
        del args
    bytes_ms = tot["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = tot["flops"] / F32_FLOPS_PER_S * 1e3
    tot["bound_ms"] = max(bytes_ms, ops_ms)
    tot["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return tot


def _profiled_us(mix, make, run, library, kernel, iters=20):
    """[(kernel us, library us)] a call for each layer of `mix`, from the
    kernel durations of one torch.profiler session, or None if the session
    lost kernels three times. Each layer's `iters` calls of run (one launch
    of the kernel whose name holds `kernel`) and of library (every kernel and
    copy it launches) run inside a record_function window; a kernel counts
    for the window its start falls in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i, (shape, affine, _) in enumerate(mix):
                args = make(shape, affine)
                for tag, fn in (("kernel", run), ("library", library)):
                    fn(*args)
                    torch.cuda.synchronize()
                    with record_function(f"mix{i}.{tag}"):
                        for _ in range(iters):
                            fn(*args)
                        torch.cuda.synchronize()
                del args
        events = prof.events()
        windows = {e.name: e.time_range for e in events
                   if e.device_type == DeviceType.CPU and e.name.startswith("mix")}
        work = [e for e in events if e.device_type == DeviceType.CUDA
                and not e.name.startswith("mix") and not getattr(e, "is_user_annotation", False)]
        out = []
        for i in range(len(mix)):
            k_win, l_win = windows[f"mix{i}.kernel"], windows[f"mix{i}.library"]
            k = [e.time_range.elapsed_us() for e in work
                 if k_win.start <= e.time_range.start <= k_win.end and kernel in e.name]
            lib = [e.time_range.elapsed_us() for e in work
                   if l_win.start <= e.time_range.start <= l_win.end]
            if len(k) != iters or not lib:
                log(f"[kernel] torch.profiler: {len(work)} device events in the session, "
                    f"{len(k)} of {iters} {kernel} launches in window {i}")
                break
            out.append((sum(k) / iters, sum(lib) / iters))
        else:
            return out
    return None


def _queued_us(fn, iters=20):
    """Device microseconds a call of fn() by CUDA events, its `iters` calls
    queued behind a busy kernel of ~10 ms so that the card runs them back to
    back: the host's gaps between launches do not count, the card's own gap
    between two kernels does."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(20_000_000)  # ~10 ms of cycles at the H100's 1.98 GHz boost clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    if queued > 0.005:  # the card may have caught up with the host
        raise AssertionError(f"queuing {iters} calls took {queued * 1e3:.2f} ms of host")
    return start.elapsed_time(end) * 1e3 / iters


def _device_us(mix, make, run, library, kernel):
    """([(kernel us, library us)] a call for each layer of `mix`, the source):
    torch.profiler's kernel durations or, where its sessions lose the kernels
    (on the H100 after the earlier phases' sessions in the same process),
    CUDA events over calls queued behind a busy kernel."""
    # keep CUPTI set up between sessions (its teardown and lazy re-init after
    # each session is what PyTorch itself turns off where it loses events)
    os.environ["TEARDOWN_CUPTI"] = "0"
    out = _profiled_us(mix, make, run, library, kernel)
    if out is not None:
        return out, "torch.profiler"
    out = []
    for shape, affine, _ in mix:
        args = make(shape, affine)
        out.append((_queued_us(lambda: run(*args)), _queued_us(lambda: library(*args))))
        del args
    return out, "CUDA events behind a queued busy kernel; torch.profiler lost the kernels"


def _log_total(tag, work, tot):
    more = "".join(f"{k[:-3]} {v:.4f} ms, " for k, v in tot.items()
                   if k.endswith("_ms") and k not in ("plain_ms", "library_ms", "bound_ms"))
    log(f"[kernel] {tag} per {work}: kernel {tot['ms']:.4f} ms, {more}plain "
        f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms ({tot['bytes'] / 1e9:.3f} GB at 3.35 TB/s, "
        f"{tot['bound_by']})")


def _op_overhead():
    """Host microseconds a K1 call costs through the dispatcher op, through
    the bare wrapper `_launch` and through the wrapper under a device guard
    (what a launch on a non-current device pays), at a shape whose kernel is
    trivial (1x1x8x8), in turns, 5000 calls each."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    x = torch.randn(1, 1, 8, 8, device="cuda")

    def guarded():  # the wrapper under a device guard, as a launch on another device runs
        with torch.cuda.device(x.device):
            K._launch(x, None, None, 1e-5, "relu")

    calls = {"op": lambda: torch.ops.aclgan.instance_norm_fwd(x, None, None, 1e-5, 1),
             "wrapper": lambda: K._launch(x, None, None, 1e-5, "relu"),
             "guarded": guarded}
    us = {"op": [], "wrapper": [], "guarded": []}
    for turn in ("op", "wrapper", "guarded", "guarded", "wrapper", "op"):
        for _ in range(200):
            calls[turn]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5000):
            calls[turn]()
        torch.cuda.synchronize()
        us[turn].append((time.perf_counter() - t0) / 5000 * 1e6)
    log(f"[kernel] instance_norm host cost a call (1x1x8x8, 5000 calls, in turns): "
        f"through the aclgan:: op {', '.join(f'{u:.2f}' for u in us['op'])} us, bare "
        f"wrapper {', '.join(f'{u:.2f}' for u in us['wrapper'])} us, the wrapper under "
        f"torch.cuda.device {', '.join(f'{u:.2f}' for u in us['guarded'])} us")


# K1's and K2's layouts beside the model's (label, shape, storage offset)
FUSED_EDGE_CASES = (
    ("phase 27's one-process 512^2 rows (streaming)", (2, 64, 512, 512), 0),
    ("48 x 40 rows (1,920 elements, not a multiple of a CTA's 2,048)", (2, 8, 48, 40), 0),
    ("odd 45 x 43 rows (one element a load)", (2, 8, 45, 43), 0),
    ("bases off 16 bytes (storage offset 1)", (2, 8, 64, 64), 1))


def _at_offset(t, offset):
    """t's values in a contiguous view `offset` elements into a flat buffer."""
    buf = torch.empty(t.numel() + offset, device=t.device, dtype=t.dtype)
    buf[offset:].copy_(t.flatten())
    return buf[offset:].view(t.shape)


def _fused_plans(inputs, *tensors):
    """The plans a check holds K1 (inputs 1) or K2 (3) to on the tensors'
    layout: `_fused_plan`'s, then the streaming variant where that one is on
    chip."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    n, c, h, w = tensors[0].shape
    plan = K._fused_plan(n * c, h * w, tensors[0].element_size(),
                         K._align(*(t.data_ptr() for t in tensors)), inputs)
    return [plan] + ([(1, plan[1], False)] if plan[2] else [])


def _fused_cases():
    """(label, shape, storage offset): the model's layers, then the edge cases."""
    return [(f"{shape}", shape, 0) for shape in MAIN_SHAPES] + list(FUSED_EDGE_CASES)


def _within(what, got, want, lim):
    """Raises unless every |got - want| <= lim and got is finite; returns the
    largest |got - want|."""
    err = (got.float() - want.float()).abs()
    bad = (err > lim).sum().item()
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: {bad} values beyond tolerance, max err "
                             f"{err.max().item()}")
    return err.max().item()


def _check_k1(x, s, b, activ, tol, what):
    """K1's variants on x against `instance_norm_plain` (y, elementwise) and
    `instance_norm_stats_plain` ((mean, rsig) within 1e-5 + 1e-5 relative):
    the planned variant through the no-grad op and with its statistics, two
    launches bit-equal, then the streaming one. Returns (max abs err of y,
    max rel err of the statistics, the planned variant's (y, mean, rsig))."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    want = K.instance_norm_plain(x, s, b, activ=activ)
    want_stats = K.instance_norm_stats_plain(x)
    s32, b32 = K._affine_f32(s, b, x)
    y_err = stats_err = 0.0
    planned = None
    for i, plan in enumerate(_fused_plans(1, x)):
        case = f"instance_norm {what} {x.dtype} affine={s is not None} {activ} plan {plan}"
        y, mean, rsig = K._launch(x, s32, b32, 1e-5, activ, stats=True, plan=plan)
        again = (K.fused_instance_norm(x, s, b, activ=activ) if i == 0 else
                 K._launch(x, s32, b32, 1e-5, activ, plan=plan))
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            raise AssertionError(f"{case}: two launches differ")
        y_err = max(y_err, _within(case, y, want, tol + tol * want.float().abs()))
        for name, got, ref in zip(("mean", "rsig"), (mean, rsig), want_stats):
            err = _within(f"{case} {name}", got, ref, 1e-5 + 1e-5 * ref.abs())
            stats_err = max(stats_err, err / max(ref.abs().max().item(), 1e-30))
        if i == 0:
            planned = (y, mean, rsig)
    return y_err, stats_err, planned


def _check_k2(x, s, y, dy, mean, rsig, activ, tol, what):
    """K2's variants fed K1's statistics against `instance_norm_bwd_plain`
    without them (`_bwd_kernel`'s function: the statistics from x): dx
    elementwise as K1's y, dscale and dshift against their largest; two
    launches bit-equal. Returns {output: max abs err}."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    want = K.instance_norm_bwd_plain(x, s, y, dy, 1e-5, activ)
    errs = {"dx": 0.0, "dscale": 0.0, "dshift": 0.0}
    for plan in _fused_plans(3, x, y, dy):
        case = f"instance_norm_bwd {what} {x.dtype} affine={s is not None} {activ} plan {plan}"
        got = K.instance_norm_bwd(x, s, y, dy, mean, rsig, activ, plan=plan)
        again = K.instance_norm_bwd(x, s, y, dy, mean, rsig, activ, plan=plan)
        torch.cuda.synchronize()
        for name, o, o2, w in zip(errs, got, again, want):
            if s is None and name != "dx":  # IN: no dscale, dshift
                if o is not None:
                    raise AssertionError(f"{case}: {name} returned without a scale")
                continue
            if not torch.equal(o, o2):
                raise AssertionError(f"{case} {name}: two launches differ")
            lim = tol + tol * w.float().abs() if name == "dx" else tol * w.abs().max()
            errs[name] = max(errs[name], _within(f"{case} {name}", o, w, lim))
    return errs


def _plan_label(plan):
    ctas, vec, on_chip = plan
    return (f"plan ({ctas} CTA{'s' if ctas > 1 else ''} a row, {vec} a load, "
            f"{'on chip' if on_chip else 'streaming'})")


def _fused_device(tag, mix, make, run, library, kernel, nbytes, tot, work):
    """K1's or K2's device time a launch at each layer of `mix` (`_device_us`:
    torch.profiler, or CUDA events behind a queued busy kernel where it loses
    the kernels) beside the library call's, with GB/s and the plan, summed
    over the mix; logs them and returns the kernels-line keys."""
    device, source = _device_us(mix, make, run, library, kernel)
    device_ms = library_device_ms = 0.0
    for (shape, affine, count), (dev_us, lib_us) in zip(mix, device):
        device_ms += count * dev_us / 1e3
        library_device_ms += count * lib_us / 1e3
        log(f"[kernel] {tag} bf16 {shape} affine={affine} x{count}: device a launch kernel "
            f"{dev_us:.2f} us, library {lib_us:.2f} us, "
            f"{nbytes(shape, affine) / dev_us / 1e3:.0f} GB/s")
    log(f"[kernel] {tag} device time per {work} ({source}): kernel {device_ms:.4f} ms (bound / "
        f"device {100 * tot['bound_ms'] / device_ms:.1f}%), library {library_device_ms:.4f} ms")
    return dict(device_ms=device_ms, library_device_ms=library_device_ms, device_source=source)


def phase_instance_norm_kernel():
    """K1 against its plain version, both variants, with its statistics;
    returns its kernels-line entry and a function that measures its device
    time (called after the last phase: a profiler session this early could
    change the later phases' traces)."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = stats_rel = 0.0
    for label, shape, offset in _fused_cases():
        n, c = shape[:2]
        base = torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.5
        scale = torch.randn(n, c, device="cuda", generator=g)
        shift = torch.randn(n, c, device="cuda", generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x = _at_offset(base.to(dtype), offset)
            plans = _fused_plans(1, x)
            for affine in (False, True):
                for activ in ("none", "relu", "lrelu", "tanh"):
                    args = (scale, shift) if affine else (None, None)
                    y_err, s_err, _ = _check_k1(x, *args, activ, TOL[dtype], label)
                    max_err, stats_rel = max(max_err, y_err), max(stats_rel, s_err)
            log(f"[kernel] instance_norm {label} {dtype}: 8 cases within tolerance, "
                f"{', '.join(_plan_label(p) for p in plans)}; mean / rsig within 1e-5")
            del x
        del base
    log(f"[kernel] instance_norm max abs err {max_err:.3g}; mean / rsig against "
        f"instance_norm_stats_plain max rel {stats_rel:.3g}")

    def make(shape, affine):
        n, c, h, w = shape
        x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        scale = torch.randn(n, c, device="cuda", generator=g) if affine else None
        shift = torch.randn(n, c, device="cuda", generator=g) if affine else None
        xv = x.view(1, n * c, h, w)
        return (x, scale, shift, xv, None if scale is None else scale.flatten(),
                None if shift is None else shift.flatten())

    def run(x, scale, shift, *_):
        return K.fused_instance_norm(x, scale, shift, activ="relu")

    def streaming(x, scale, shift, *_):
        return K._launch(x, scale, shift, 1e-5, "relu", plan=(1, _fused_plans(1, x)[0][1], False))

    def plain(x, scale, shift, *_):
        return K.instance_norm_plain(x, scale, shift, activ="relu")

    def library(x, scale, shift, xv, wv, bv):
        return F.instance_norm(xv, weight=wv, bias=bv, eps=1e-5)

    def nbytes(shape, affine):  # read x, write y (+ the f32 scale and shift)
        return 2 * 2 * math.prod(shape) + (2 * 4 * shape[0] * shape[1] if affine else 0)

    def describe(x, *_):
        return _plan_label(_fused_plans(1, x)[0])

    _op_overhead()
    # serving: per Translator batch of 32, IN at 256^2 x64 once, 128^2 x128
    # once, 64^2 x256 nine times, AdaIN at 64^2 x256 eight times
    mixes = {"serving": _encode_mix(BATCH) + _decode_mix(BATCH),
             "train": _d_step_mix(TRAIN_BATCH) + _g_step_mix(TRAIN_BATCH)}
    works = {"serving": f"bf16 Translator batch of {BATCH} ({LAUNCHES_PER_BATCH} launches)",
             "train": f"bf16 D+G iteration at batch {TRAIN_BATCH} ({2 * K1_PER_STEP} launches)"}
    tots = {}
    for key, mix in mixes.items():
        tots[key] = _time_mix("instance_norm", mix, make, run, plain, library, nbytes, 10.0,
                              extra={"streaming": streaming}, describe=describe)
        _log_total("instance_norm", works[key], tots[key])
    serving, train = tots["serving"], tots["train"]
    entry = dict(
        name="instance_norm_fwd", route="cuda",
        source="aclgan_tpu_torch/csrc/instance_norm.cu",
        replaces="aclgan_tpu/ops/pallas/instance_norm.py:67",
        launches=None, max_abs_err=max_err,
        ms=train["ms"], plain_ms=train["plain_ms"], bound_ms=train["bound_ms"],
        bound_by=train["bound_by"], library_ms=train["library_ms"],
        streaming_ms=train["streaming_ms"],
        library="F.instance_norm on the (1, N*C, H, W) view (no activation)",
        work=f"one bf16 D+G training iteration at batch {TRAIN_BATCH}, 256^2: "
             f"{2 * K1_PER_STEP} launches; per Translator batch of {BATCH}: "
             f"{serving['ms']:.4f} ms (bound {serving['bound_ms']:.4f})")

    def device():
        out = {}
        for key in ("serving", "train"):
            out[key] = _fused_device("instance_norm", mixes[key], make, run, library,
                                     "instance_norm_fwd", nbytes, tots[key], works[key])
        return dict(out["train"], serving_ms=serving["ms"],
                    serving_device_ms=out["serving"]["device_ms"])

    return entry, device


def phase_instance_norm_bwd_kernel():
    """K2, both variants, fed K1's statistics, against its plain version
    without them at the training shapes and the edge cases; returns its
    kernels-line entry and a function that measures its device time (as
    phase 3's)."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    g = torch.Generator(device="cuda").manual_seed(1)
    max_err = {"dx": 0.0, "dscale": 0.0, "dshift": 0.0}
    for label, shape, offset in [(f"{s}", s, 0) for s in TRAIN_SHAPES] + list(FUSED_EDGE_CASES):
        n, c = shape[:2]
        base = torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.5
        dy_base = torch.randn(shape, device="cuda", generator=g)
        scale = torch.randn(n, c, device="cuda", generator=g)
        shift = torch.randn(n, c, device="cuda", generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = _at_offset(base.to(dtype), offset), _at_offset(dy_base.to(dtype), offset)
            tol = TOL[dtype]
            plans = None
            for affine in (False, True):
                for activ in ("none", "relu", "lrelu", "tanh"):
                    args = (scale, shift) if affine else (None, None)
                    y, mean, rsig = _check_k1(x, *args, activ, tol, label)[2]
                    plans = plans or _fused_plans(3, x, y, dy)
                    errs = _check_k2(x, args[0], y, dy, mean, rsig, activ, tol, label)
                    max_err = {k: max(v, errs[k]) for k, v in max_err.items()}
                    del y, mean, rsig
            log(f"[kernel] instance_norm_bwd {label} {dtype}: 8 cases within tolerance (dx, "
                f"dscale, dshift; fed K1's statistics, against the plain version without "
                f"them), {', '.join(_plan_label(p) for p in plans)}")
            del x, dy
        del base, dy_base
    log(f"[kernel] instance_norm_bwd max abs err: " + ", ".join(
        f"{k} {v:.3g}" for k, v in max_err.items()))

    def make(shape, affine):
        n, c, h, w = shape
        x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        scale = torch.randn(n, c, device="cuda", generator=g) if affine else None
        shift = torch.randn(n, c, device="cuda", generator=g) if affine else None
        y, kmean, krsig = K._launch(x, scale, shift, 1e-5, "relu", stats=True)
        dy = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        # the library call gets the stats from a forward; it does not redo them
        xv, dyv = x.view(1, n * c, h, w), dy.view(1, n * c, h, w)
        wv = None if scale is None else scale.flatten()
        _, mean, invstd = torch.ops.aten.native_batch_norm(
            xv, wv, None if shift is None else shift.flatten(), None, None, True, 0.0,
            1e-5)
        return (x, scale, y, dy, kmean, krsig, xv, dyv, wv, mean, invstd,
                [True, affine, affine])

    def run(x, scale, y, dy, kmean, krsig, *_):
        return K.instance_norm_bwd(x, scale, y, dy, kmean, krsig, "relu")

    def streaming(x, scale, y, dy, kmean, krsig, *_):
        plan = (1, _fused_plans(3, x, y, dy)[0][1], False)
        return K.instance_norm_bwd(x, scale, y, dy, kmean, krsig, "relu", plan=plan)

    def plain(x, scale, y, dy, *_):
        return K.instance_norm_bwd_plain(x, scale, y, dy, 1e-5, "relu")

    def library(x, scale, y, dy, kmean, krsig, xv, dyv, wv, mean, invstd, mask):
        return torch.ops.aten.native_batch_norm_backward(
            dyv, xv, wv, None, None, mean, invstd, True, 1e-5, mask)

    def nbytes(shape, affine):  # read x, y, dy, write dx, read mean, rsig (+ scale, ds, db)
        return 4 * 2 * math.prod(shape) + (5 if affine else 2) * 4 * shape[0] * shape[1]

    def describe(x, scale, y, dy, *_):
        return _plan_label(_fused_plans(3, x, y, dy)[0])

    mix = _g_step_mix(TRAIN_BATCH)
    work = f"bf16 G step at batch {TRAIN_BATCH} ({K2_PER_G_STEP} launches)"
    tot = _time_mix("instance_norm_bwd", mix, make, run, plain, library, nbytes, 20.0,
                    extra={"streaming": streaming}, describe=describe)
    _log_total("instance_norm_bwd", work, tot)
    entry = dict(
        name="instance_norm_bwd", route="cuda",
        source="aclgan_tpu_torch/csrc/instance_norm.cu",
        replaces="aclgan_tpu/ops/pallas/instance_norm.py:102",
        launches=None, max_abs_err=max(max_err.values()),
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by=tot["bound_by"], library_ms=tot["library_ms"],
        streaming_ms=tot["streaming_ms"],
        library="aten.native_batch_norm_backward on the (1, N*C, H, W) view, given "
                "saved stats, no activation gate",
        work=f"one bf16 G step at batch {TRAIN_BATCH}, 256^2: {K2_PER_G_STEP} launches")

    def device():
        return _fused_device("instance_norm_bwd", mix, make, run, library, "instance_norm_bwd",
                             nbytes, tot, work)

    return entry, device


def _requests():
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(N_REQUESTS)]
    styles = rng.randn(N_REQUESTS, 8).astype(np.float32)
    return imgs, styles


def _check_outputs(outs, masks, tag):
    if len(outs) != N_REQUESTS or len(masks) != N_REQUESTS:
        raise AssertionError(f"{tag}: {len(outs)} outputs, {len(masks)} masks")
    for o, m in zip(outs, masks):
        if o.shape != (256, 256, 3) or o.dtype != np.uint8:
            raise AssertionError(f"{tag}: output {o.shape} {o.dtype}")
        if m.shape != (256, 256, 1) or not np.isfinite(m).all():
            raise AssertionError(f"{tag}: mask {m.shape}")
        if o.min() == o.max():
            raise AssertionError(f"{tag}: a constant output image")


def phase_translator_f32(cfg, ckpt):
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.serving import Translator

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, compute_dtype="float32"))
    imgs, styles = _requests()
    tr = Translator(cfg32, ckpt, batch_size=BATCH)
    K.launches = 0
    outs, masks = tr(imgs, styles, return_masks=True)
    torch.cuda.synchronize()
    launches = K.launches
    n_batches = -(-N_REQUESTS // BATCH)
    if launches != LAUNCHES_PER_BATCH * n_batches:
        raise AssertionError(f"instance_norm launched {launches} times for "
                             f"{n_batches} batches, expected {LAUNCHES_PER_BATCH} each")
    _check_outputs(outs, masks, "f32 cuda")

    t0 = time.time()
    ref = Translator(cfg32, ckpt, batch_size=BATCH, device="cpu")
    ref_outs, ref_masks = ref(imgs, styles, return_masks=True)
    diff = np.abs(np.stack(outs).astype(np.int16) - np.stack(ref_outs).astype(np.int16))
    mask_err = float(np.abs(np.stack(masks) - np.stack(ref_masks)).max())
    log(f"[translator f32] {N_REQUESTS} requests, {n_batches} batches, "
        f"{launches} kernel launches; vs CPU: max {diff.max()} LSB, mean "
        f"{diff.mean():.5f} LSB, mask max err {mask_err:.2e} "
        f"(CPU reference {time.time() - t0:.1f} s)")
    if diff.max() > 2:
        raise AssertionError(f"f32 CUDA Translator differs from CPU by {diff.max()} LSB")
    return outs


_KERNEL_GROUPS = [  # (group, substrings of the CUDA kernel name), first match wins
    ("instance_norm (K1)", ("instance_norm_fwd",)),
    ("instance_norm backward (K2)", ("instance_norm_bwd",)),
    ("convolution", ("conv", "xmma", "gemm", "cudnn", "cutlass", "implicit")),
    ("pad", ("pad",)),
    ("upsample", ("upsample",)),
    ("avg pool", ("avg_pool",)),
    ("optimizer (Adam)", ("adam", "multi_tensor")),
    ("copy / cast", ("copy", "memcpy", "memset")),
]


def _profile(what, fn, launches=None, split=None):
    """Device time by kernel group over one call of fn(), with torch.profiler;
    returns (wall ms, device busy ms). With `launches` (K1, K2), the trace's
    K1 and K2 kernel events are held to them by `_hold_trace`: a count read
    from the device's own record, which a replayed CUDA graph's counters are
    not. A dict `split` gets each split kernel's (device ms, events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    # the first device event against the first call that queues device work:
    # below 0, the device's timestamps read behind the host's
    trace = prof.events()
    calls = [e.time_range.start for e in trace if e.device_type == DeviceType.CPU
             and e.name.startswith("cuda")
             and any(s in e.name for s in ("Launch", "Memcpy", "Memset"))]
    device = [e.time_range.start for e in trace if e.device_type == DeviceType.CUDA]
    offset = (f"{(min(device) - min(calls)) / 1e3:.3f} ms" if calls and device
              else "not measured")
    groups: dict = {}
    kernels = []
    for e in prof.key_averages():
        # a user annotation (`Optimizer.step#Adam.step`) spans kernels listed too
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        ms = e.self_device_time_total / 1e3
        kernels.append((ms, e.count, e.key))
        name = e.key.lower()
        group = next((g for g, subs in _KERNEL_GROUPS if any(s in name for s in subs)),
                     "other elementwise / reduction")
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(groups.values())
    events = tuple(sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and mark in e.key)
                   for mark in ("instance_norm_fwd", "instance_norm_bwd"))
    log(f"[profile] {what}: {wall_ms:.2f} ms wall, "
        f"{busy:.2f} ms device busy ({100 * (1 - busy / wall_ms):.1f}% idle); "
        f"(K1, K2) kernel events {events}; first device event minus first launch "
        f"{offset}")
    if launches is not None:
        _hold_trace(what, events, launches)
    if split is not None:
        for name, mark in SPLIT_KERNEL_NAMES.items():
            # the kernel's own name: "apply_kernel" is not "bwd_apply_kernel", nor a
            # library kernel's "...::(anonymous namespace)::apply_kernel"
            own = re.compile(rf"(^|\s)(\(anonymous namespace\)::)?{mark}\b")
            mine = [(ms, n) for ms, n, key in kernels if own.search(key)]
            split[name] = (sum(ms for ms, _ in mine), sum(n for _, n in mine))
        log(f"[profile]   split kernels (device ms, events): {split}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {g}: {ms:.2f} ms ({100 * ms / wall_ms:.1f}% of wall)")
    kernels.sort(reverse=True)
    for ms, count, key in kernels[:15]:
        log(f"[profile]   {ms:8.2f} ms x{count:<5d} {key[:110]}")
    return wall_ms, busy


def phase_translator_bf16(cfg, ckpt, outs32):
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.serving import Translator

    imgs, styles = _requests()
    tr = Translator(cfg, ckpt, batch_size=BATCH)
    K.launches = 0
    outs, masks = tr(imgs, styles, return_masks=True)
    torch.cuda.synchronize()
    if K.launches != LAUNCHES_PER_BATCH * -(-N_REQUESTS // BATCH):
        raise AssertionError(f"bf16: {K.launches} kernel launches")
    _check_outputs(outs, masks, "bf16 cuda")
    diff = np.abs(np.stack(outs).astype(np.int16) - np.stack(outs32).astype(np.int16))

    window, win_styles = _window(imgs, styles)
    torch.cuda.reset_peak_memory_stats()
    rates = _img_rates(tr, window, win_styles)
    peak = torch.cuda.max_memory_allocated()
    log(f"[translator bf16] batch {BATCH}: p50 {np.median(rates):.1f} img/s over "
        f"7 windows of {len(window)} requests ({', '.join(f'{r:.1f}' for r in rates)}); "
        f"peak memory {peak / 2**30:.3f} GiB ({peak} B), the graph's pool "
        f"{_pool(tr.model)}; vs f32: max {diff.max()} LSB, mean {diff.mean():.4f} LSB")
    if diff.mean() > 8:
        raise AssertionError(f"bf16 outputs drift {diff.mean():.2f} LSB on average from f32")
    _profile(f"one window of {len(window)} requests", lambda: tr(window, win_styles),
             (LAUNCHES_PER_BATCH * len(window) // BATCH, 0))
    return outs


def _window(imgs, styles):
    """4 full batches of requests."""
    return (imgs * 2)[:4 * BATCH], np.concatenate([styles, styles])[:4 * BATCH]


def _img_rates(tr, window, win_styles, windows=7):
    """img/s of `tr` over `windows` calls on `window` (CUDA events), after
    2 warm-up calls."""
    for _ in range(2):
        tr(window, win_styles)
    rates = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr(window, win_styles)
        end.record()
        torch.cuda.synchronize()
        rates.append(len(window) / (start.elapsed_time(end) / 1e3))
    return rates


def _train_model(cfg, device, seed=0, graphs=True, mesh=None):
    from aclgan_tpu_torch.trainer import ACLGAN

    model = ACLGAN(cfg, device=device, seed=seed, graphs=graphs, mesh=mesh)
    model.init_state()
    return model


def _pool(model):
    """The GiB a model's CUDA graphs reserve, as a phase prints it."""
    if model.graphs is None:
        return "none (eager)"
    return f"{model.graphs.pool_bytes / 2**30:.3f} GiB ({model.graphs.pool_bytes} B)"


def _grads(model):
    from aclgan_tpu_torch.trainer import DIS_NAMES, GEN_NAMES

    nets = [(n, model.gen(n)) for n in GEN_NAMES] + [(n, model.dis(n)) for n in DIS_NAMES]
    return {n: torch.cat([p.grad.detach().double().flatten().cpu() for p in net.parameters()])
            for n, net in nets}


def phase_train_f32(cfg):
    """One D+G iteration and one D iteration in float32 on the card against the
    same on the CPU (plain versions), from the same weights, batches and z."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    size, b = 128, 2
    cfg = dataclasses.replace(
        cfg, focus_delta=0.0, focus_epsilon=10.0,  # smooth focus terms
        tpu=dataclasses.replace(cfg.tpu, compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, crop_image_height=size, crop_image_width=size))
    rng = np.random.RandomState(0)
    batches = [tuple(rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8)
                     for _ in range(2)) for _ in range(2)]
    zs = [{k: [rng.randn(b, cfg.gen.style_dim).astype(np.float32) for _ in range(3)]
           for k in ("dis", "gen")} for _ in range(2)]
    schedule = [(True, True), (True, False)]  # iteration 0: D+G, iteration 1: D

    def run(device):
        model = _train_model(cfg, device)
        out, counts, grads = [], [], None
        for (xa, xb), z, (do_dis, do_gen) in zip(batches, zs, schedule):
            K.launches = K.bwd_launches = 0
            m = model.train_step(xa, xb, do_dis, do_gen, z=z)
            out.append({k: float(v) for k, v in m.items()})  # syncs
            counts.append((K.launches, K.bwd_launches))
            if grads is None:
                grads = _grads(model)
        return out, counts, grads

    t0 = time.time()
    got, counts, got_grads = run("cuda")
    cuda_s = time.time() - t0
    want_counts = [(2 * K1_PER_STEP, K2_PER_G_STEP), (K1_PER_STEP, 0)]
    if counts != want_counts:
        raise AssertionError(f"train f32: (K1, K2) launches per iteration {counts}, "
                             f"expected {want_counts}")
    t0 = time.time()
    want, cpu_counts, want_grads = run("cpu")
    if cpu_counts != [(0, 0), (0, 0)]:
        raise AssertionError(f"the CPU run launched kernels: {cpu_counts}")
    worst = 0.0
    for it, (g, w) in enumerate(zip(got, want)):
        if set(g) != set(w):
            raise AssertionError(f"train f32 iteration {it}: metric keys differ")
        for k in w:
            rel = abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
            worst = max(worst, rel)
            if not math.isfinite(g[k]) or rel > 1e-3:
                raise AssertionError(f"train f32 iteration {it} {k}: card {g[k]} vs CPU "
                                     f"{w[k]} (rel {rel:.2e} > 1e-3)")
    grad_err = {n: float((got_grads[n] - want_grads[n]).norm()
                         / want_grads[n].norm().clamp_min(1e-30)) for n in want_grads}
    if max(grad_err.values()) > 1e-2:
        raise AssertionError(f"train f32 gradients: rel-L2 {grad_err} > 1e-2")
    log(f"[train f32] male2female full width, {size}^2, batch {b}: D+G then D iteration, "
        f"(K1, K2) launches {counts}; vs CPU: metrics max rel {worst:.2e}, gradients "
        f"rel-L2 " + ", ".join(f"{n} {e:.2e}" for n, e in grad_err.items())
        + f" (card {cuda_s:.1f} s, CPU {time.time() - t0:.1f} s)")


def phase_train_bf16(cfg):
    """The shipped config (bf16) at 256^2, batch 16: 4 warm-up iterations (each
    key's eager call and its capture), then 5 timed windows of 8 iterations
    at the D1/G2 cadence (CUDA events), then one profiled D+G iteration.
    Returns the (K1, K2) launches of the first (D+G) iteration."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    b = TRAIN_BATCH
    model = _train_model(cfg, "cuda")
    rng = np.random.RandomState(1)
    batches = [tuple(torch.from_numpy(rng.randint(0, 256, (b, 256, 256, 3), dtype=np.uint8))
                     .cuda() for _ in range(2)) for _ in range(4)]
    it = 0

    def iteration():
        nonlocal it
        xa, xb = batches[it % len(batches)]
        m = model.train_step(xa, xb, it % cfg.D_update == 0, it % cfg.G_update == 0)
        it += 1
        return m

    torch.cuda.reset_peak_memory_stats()
    K.launches = K.bwd_launches = 0
    iteration()  # it 0: D+G
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    if launches != (2 * K1_PER_STEP, K2_PER_G_STEP):
        raise AssertionError(f"train bf16: D+G iteration launched (K1, K2) {launches}")
    for _ in range(3):
        iteration()
    rates, window = [], 8
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = [iteration() for _ in range(window)]
        end.record()
        torch.cuda.synchronize()
        rates.append(window / (start.elapsed_time(end) / 1e3))
    peak = torch.cuda.max_memory_allocated()
    bad = [k for m in metrics for k, v in m.items() if not torch.isfinite(v)]
    if bad:
        raise AssertionError(f"train bf16: non-finite losses {sorted(set(bad))}")
    last = {k: round(float(v), 4) for m in metrics[-2:] for k, v in m.items()}
    p50 = float(np.median(rates))
    log(f"[train bf16] male2female 256^2 batch {b}, D{cfg.D_update}/G{cfg.G_update}: "
        f"p50 {p50:.3f} it/s = {p50 * b:.2f} img/s over 5 windows of {window} "
        f"iterations ({', '.join(f'{r:.3f}' for r in rates)} it/s); peak memory "
        f"{peak / 2**30:.3f} GiB ({peak} B), the graphs' pool {_pool(model)}; every loss "
        f"finite; last losses {last}")
    if it % cfg.G_update:
        iteration()
    # each kind of iteration alone, in turns (the step is even here, so D+G
    # comes first): device ms (CUDA events, median of 3); a replay runs no
    # aten op in Python, so the FLOPs are counted on an eager step (phase 29)

    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        iteration()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    times = {"D+G": [], "D": []}
    for _ in range(3):
        for kind in times:
            times[kind].append(timed())
    for kind, ts in times.items():
        log(f"[train bf16] one {kind} iteration: {float(np.median(ts)):.2f} ms "
            f"({', '.join(f'{t:.2f}' for t in ts)})")
    _profile(f"one D+G training iteration at batch {b}", iteration,
             (2 * K1_PER_STEP, K2_PER_G_STEP))
    return launches, 1.0 / p50


# the JAX CLI's scalars.jsonl keys at the shipped config (tests/test_torch_cli.py
# holds the port's key set to the JAX CLI's on the CPU)
CLI_KEYS = {"step", "time", "loss_dis_A", "loss_dis_B", "loss_dis_2", "loss_dis_total",
            "loss_gen_adv_A", "loss_gen_adv_B", "loss_gen_adv_2", "loss_idt_A",
            "loss_idt_B", "loss_gen_total"} | {
    f"loss_gen_focus_{n}_{t}" for n in ("A", "B", "A2") for t in ("size", "digit")}
K1_PER_SAMPLE = 3 * 11 + 3 * 8  # 3 content encodes, 3 decodes (focus rows)
TRACE_MARK = "instance_norm_fwd"  # K1's name in a device trace
_ITERATION = re.compile(r"^Iteration: (\d+)/\d+ \(([0-9.]+)s\)$")


class _Tee(io.TextIOBase):
    """stdout that also keeps the lines written to it."""

    def __init__(self, out):
        self.out, self.lines, self._part = out, [], ""

    def write(self, s):
        self.out.write(s)
        *done, self._part = (self._part + s).split("\n")
        self.lines += done
        return len(s)

    def flush(self):
        self.out.flush()


def _run_cli(argv):
    """`cli.train.main(argv)` in process; returns (its stdout lines, its
    `TrainRun`)."""
    from aclgan_tpu_torch.cli.train import main as train_main

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        run = train_main(argv)
    return tee.lines, run


def _cli_config(cfg, tmp, name, **changes):
    """The shipped config on the synthetic dataset (no data_root), with
    `changes`, written where the CLI reads it."""
    from aclgan_tpu_torch.config import save_config

    derived = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, synthetic=True, data_root=None), **changes)
    path = Path(tmp) / f"{name}.yaml"
    save_config(derived, path)
    return derived, str(path)


def _cadence(cfg, epoch_len, first, last):
    """(do_dis, do_gen) of global iterations first..last (1-based) of a run
    that started at `first`: the CLI's epoch-local cadence."""
    out = {}
    for i in range(first, last + 1):
        it = (i - first) % epoch_len
        out[i] = (it % cfg.D_update == 0, it % cfg.G_update == 0)
    return out


def _expected_launches(cadence, samples):
    n_dis = sum(d for d, _ in cadence.values())
    n_gen = sum(g for _, g in cadence.values())
    return (K1_PER_STEP * (n_dis + n_gen) + K1_PER_SAMPLE * samples,
            K2_PER_G_STEP * n_gen)


def _replayed_launches(cadence):
    """(K1, K2) of the iterations of `cadence` that replay a graph: each
    update kind's calls after its eager first and its capturing second."""
    seen = {}
    replays = {}
    for i, kind in sorted(cadence.items()):
        if any(kind):
            seen[kind] = seen.get(kind, 0) + 1
            if seen[kind] > 2:
                replays[i] = kind
    return _expected_launches(replays, samples=0)


def _cli_seconds(lines, cadence, skip):
    """p50 seconds of the D+G and of the D iterations, read from the CLI's
    `Iteration:` lines, leaving out the iterations in `skip`, and the
    seconds per iteration at the D1/G2 cadence (their mean)."""
    times = {"D+G": [], "D": []}
    for line in lines:
        m = _ITERATION.match(line)
        if m and int(m[1]) not in skip:
            times["D+G" if cadence[int(m[1])][1] else "D"].append(float(m[2]))
    p50 = {k: float(np.median(v)) for k, v in times.items()}
    return p50, (p50["D+G"] + p50["D"]) / 2, {k: len(v) for k, v in times.items()}


def _records(log_dir):
    with open(Path(log_dir) / "scalars.jsonl") as f:
        return [json.loads(line) for line in f]


def _check_records(recs, steps, tag):
    if [r["step"] for r in recs] != list(steps):
        raise AssertionError(f"{tag}: scalars.jsonl steps {[r['step'] for r in recs]}")
    for r in recs:
        if set(r) != CLI_KEYS:
            raise AssertionError(f"{tag}: step {r['step']} keys differ from the JAX CLI's "
                                 f"by {sorted(set(r) ^ CLI_KEYS)}")
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{tag}: step {r['step']} non-finite {bad}")


def _leaves(obj, prefix=""):
    """{path: leaf} of nested dicts, lists and tuples."""
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    else:
        return {prefix: obj}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _assert_restored(model, ckpt_dir, stamp):
    """Every tensor `resume` put into `model` equals the saved files bit for
    bit; returns how many tensors were compared."""
    def load(name):
        return torch.load(Path(ckpt_dir) / name, map_location="cpu", weights_only=True)

    opt = load("optimizer.pt")
    files = {"gen": load(f"gen_{stamp:08d}.pt"), "dis": load(f"dis_{stamp:08d}.pt"),
             "gen_opt": opt["gen"], "dis_opt": opt["dis"], "rng": opt["rng"]}
    snap = model.snapshot()
    n = 0
    for key, saved in files.items():
        got, want = _leaves(snap[key]), _leaves(saved)
        if set(got) != set(want):
            raise AssertionError(f"resume: {key} has other entries than its file")
        for path, w in want.items():
            g = got[path]
            same = (g.dtype == w.dtype and torch.equal(g.detach().cpu(), w)
                    if isinstance(w, torch.Tensor) else g == w)
            if not same:
                raise AssertionError(f"resume: {key}{path} differs from its file")
            n += isinstance(w, torch.Tensor)
    if model.step != opt["step"] or opt["saved_iteration"] != stamp:
        raise AssertionError(f"resume: step {model.step}, file {opt['step']} at {stamp}")
    return n


def phase_train_cli_b3(cfg, tmp):
    """The train CLI at the config's batch of 3: 40 iterations, then --resume
    to 50. Returns (p50 s per iteration, (K1, K2) launches of the 40)."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.trainer import ACLGAN
    from aclgan_tpu_torch.utils.checkpoint import resume

    derived, path = _cli_config(cfg, tmp, "m2f_b3", image_display_iter=10,
                                image_save_iter=20, snapshot_save_iter=20)
    out = str(Path(tmp) / "b3")
    epoch_len = max(64, derived.batch_size * 8) // derived.batch_size
    cadence = _cadence(derived, epoch_len, 1, 40)
    K.launches = K.bwd_launches = 0
    t0 = time.time()
    lines, _ = _run_cli(["--config", path, "--output_path", out, "--max_iter", "40"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = (K.launches, K.bwd_launches)
    # samples: test + train grids at 20 and 40, train_current at 10/20/30/40
    want = _expected_launches(cadence, samples=2 * 2 + 4)
    if launches != want:
        raise AssertionError(f"train CLI b3: (K1, K2) launches {launches}, expected {want}")
    log_dir, run = Path(out) / "logs" / "m2f_b3", Path(out) / "outputs" / "m2f_b3"
    _check_records(_records(log_dir), range(1, 41), "train CLI b3")
    ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
    if ckpts != ["dis_00000020.pt", "dis_00000040.pt", "gen_00000020.pt",
                 "gen_00000040.pt", "optimizer.pt"]:
        raise AssertionError(f"train CLI b3: checkpoints {ckpts}")
    grids = sorted(p.name for p in (run / "images").iterdir())
    ext = Path(grids[0]).suffix
    want_grids = sorted(f"gen_a2b_{s}{ext}" for s in (
        "test_00000020", "train_00000020", "test_00000040", "train_00000040",
        "train_current"))
    if grids != want_grids or not (run / "index.html").is_file():
        raise AssertionError(f"train CLI b3: grids {grids}, index.html "
                             f"{(run / 'index.html').is_file()}")
    html = (run / "index.html").read_text()
    if any(f"images/{g}" not in html for g in want_grids):
        raise AssertionError("train CLI b3: index.html does not link every grid")
    skip = {1} | {i + 1 for i in (10, 20, 30)}  # setup; after grids/snapshots
    p50, per_it, counts = _cli_seconds(lines, cadence, skip)
    sizes = {p.name: p.stat().st_size for p in (run / "checkpoints").iterdir()}
    log(f"[train cli b3] male2female 256^2 batch {derived.batch_size}, {epoch_len} "
        f"batches an epoch: 40 iterations in {wall:.1f} s; p50 D+G {p50['D+G']:.4f} s, "
        f"D {p50['D']:.4f} s ({counts} iterations), {per_it:.4f} s per iteration at "
        f"D1/G2; (K1, K2) launches {launches}; grids {ext}; snapshot bytes {sizes}")

    # resume: a fresh model restored from the files equals them bit for bit
    check = ACLGAN(derived, device="cuda", seed=derived.seed + 5)
    check.init_state()
    resume(str(run / "checkpoints"), check)
    n_tensors = _assert_restored(check, run / "checkpoints", 40)
    del check
    torch.cuda.empty_cache()
    lines, _ = _run_cli(["--config", path, "--output_path", out, "--resume",
                         "--max_iter", "50"])
    _check_records(_records(log_dir), range(1, 51), "train CLI b3 resumed")
    opt = torch.load(run / "checkpoints" / "optimizer.pt", weights_only=True)
    if opt["step"] != 50 or opt["saved_iteration"] != 50:
        raise AssertionError(f"train CLI b3 resumed: step {opt['step']}")
    log(f"[train cli b3] --resume --max_iter 50: {n_tensors} restored tensors equal the "
        f"iteration-40 files bit for bit; records 41..50 appended; step 50; "
        f"{sum(bool(_ITERATION.match(x)) for x in lines)} Iteration lines")
    torch.cuda.empty_cache()
    bare = _bare_train_step(derived)["s"]
    log(f"[train cli b3] CLI {per_it:.4f} s per iteration against the bare train_step's "
        f"{bare:.4f} s: ratio {per_it / bare:.4f}")
    return per_it, launches


def _bare_train_step(cfg, graphs=True, windows=5, window=8, mesh=None):
    """`train_step` alone at cfg.batch_size and the config's crop (under a
    `mesh`, this rank's rows, and under a `SpatialMesh` its H-slice of a
    global batch of cfg.batch_size) on device-resident batches, as phase
    8 runs it: p50 seconds per iteration over `windows` windows of `window`
    at D1/G2 (CUDA events), the host's seconds to issue one iteration (p50 of
    6 calls, each after a synchronize), the device's idle share over one
    traced D+G and D pair (torch.profiler), peak memory, the graphs' pool and
    capture seconds, and (K1, K2) over every iteration against the cadence's
    count (under a `SpatialMesh`, (K1, K2, K1m, K1a, K2m, K2a), K1 and K2 0;
    it fails if they differ); the traced pair's K1 and K2 kernel events must
    number the pair's launches too (under a `SpatialMesh`, its split
    kernels' device ms and events are returned). Returns them as a dict."""
    from aclgan_tpu_torch.parallel.spatial import sharded, spatial_batch_sharding

    b, size = cfg.batch_size, cfg.data.crop_image_height
    split = sharded(mesh)
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    model = _train_model(cfg, "cuda", graphs=graphs, mesh=mesh)
    rng = np.random.RandomState(1)
    part = spatial_batch_sharding(mesh, b, size) if split else (slice(None), slice(None))
    batches = [tuple(torch.from_numpy(rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8))
                     [part].cuda() for _ in range(2)) for _ in range(4)]
    it, kinds = 0, {"D+G": 0, "D": 0}
    _zero_counts()

    def iteration():
        nonlocal it
        xa, xb = batches[it % len(batches)]
        do_gen = it % cfg.G_update == 0
        model.train_step(xa, xb, it % cfg.D_update == 0, do_gen)
        kinds["D+G" if do_gen else "D"] += 1
        it += 1

    for _ in range(4):  # each key's eager call and its capture
        iteration()
    torch.cuda.synchronize()
    secs, host = [], []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(window):
            iteration()
        end.record()
        torch.cuda.synchronize()
        secs.append(start.elapsed_time(end) / 1e3 / window)
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iteration()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    if it % cfg.G_update:
        iteration()
    form = "graphed" if graphs else "eager"
    split_ms = {}
    wall_ms, busy_ms = _profile(f"one D+G and one D iteration at batch {b}, {size}^2, {form}",
                                lambda: [iteration() for _ in range(2)],
                                None if split else (3 * K1_PER_STEP, K2_PER_G_STEP),
                                split_ms if split else None)
    torch.cuda.synchronize()
    k1, k2 = K1_PER_STEP * (2 * kinds["D+G"] + kinds["D"]), K2_PER_G_STEP * kinds["D+G"]
    launches, want = (_counts(), (0, 0, k1, k1, k2, k2)) if split else (_counts()[:2], (k1, k2))
    if launches != want:
        raise AssertionError(f"bare train_step b{b} {form}: launches {launches} over "
                             f"{kinds}, expected {want}")
    out = dict(s=float(np.median(secs)), host_s=float(np.median(host)),
               idle=1 - busy_ms / wall_ms, peak=torch.cuda.max_memory_allocated(),
               pool=_pool(model), launches=launches, iterations=dict(kinds),
               capture_s=[round(v, 4) for v in (model.graphs.capture_seconds.values()
                                                if graphs else ())], split_ms=split_ms)
    log(f"[train bare b{b}] train_step at batch {b}, D1/G2, {form}: p50 {out['s']:.4f} s "
        f"per iteration over {windows} windows of {window} "
        f"({', '.join(f'{x:.4f}' for x in secs)}); the host issues an iteration in "
        f"{out['host_s']:.4f} s (p50 of 6 after a sync); device idle {100 * out['idle']:.1f}% "
        f"over a traced D+G + D; peak memory {out['peak'] / 2**30:.3f} GiB ({out['peak']} B); "
        f"graphs' pool {out['pool']}, capture s {out['capture_s']}; launches {launches} "
        f"over {kinds} = the cadence's count")
    model.release_graphs()
    del model, batches
    gc_collect()
    return out


def phase_train_cli_b16(cfg, tmp, bare_s_per_it):
    """The train CLI at batch 16 for 30 iterations, traced at 10..14. Returns
    (p50 s per iteration, (K1, K2) launches)."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    b = TRAIN_BATCH
    derived, path = _cli_config(cfg, tmp, "m2f_b16", batch_size=b)
    out, prof_dir = str(Path(tmp) / "b16"), Path(tmp) / "b16_trace"
    epoch_len = max(64, b * 8) // b
    cadence = _cadence(derived, epoch_len, 1, 30)
    torch.cuda.reset_peak_memory_stats()
    K.launches = K.bwd_launches = 0
    lines, cli_run = _run_cli(["--config", path, "--output_path", out, "--max_iter", "30",
                               "--profile_dir", str(prof_dir)])
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    peak = torch.cuda.max_memory_allocated()
    want = _expected_launches(cadence, samples=0)
    if launches != want:
        raise AssertionError(f"train CLI b16: (K1, K2) launches {launches}, expected {want}")
    _check_records(_records(Path(out) / "logs" / "m2f_b16"), range(1, 31), "train CLI b16")
    trace = prof_dir / "trace.json"
    size = trace.stat().st_size if trace.is_file() else 0
    if not size or TRACE_MARK not in trace.read_text():
        raise AssertionError(f"train CLI b16: trace {trace} empty or without K1 ({size} B)")
    traced = _trace_launches(trace)
    window = _expected_launches({i: cadence[i] for i in range(11, 16)}, samples=0)
    # replayed graphs: the counters alone would not show it
    _hold_trace("train CLI b16, iterations 11..15", traced, window)
    # setup, and the traced window (profiler on) and the iteration after it
    skip = {1} | set(range(11, 17))
    p50, per_it, counts = _cli_seconds(lines, cadence, skip)
    log(f"[train cli b16] male2female 256^2 batch {b}, {epoch_len} batches an epoch: p50 "
        f"D+G {p50['D+G']:.4f} s, D {p50['D']:.4f} s ({counts} iterations), "
        f"{per_it:.4f} s per iteration at D1/G2 = {b / per_it:.2f} img/s; bare "
        f"train_step (phase 8) {bare_s_per_it:.4f} s: ratio {per_it / bare_s_per_it:.4f}; "
        f"peak memory {peak / 2**30:.3f} GiB ({peak} B), the graphs' pool "
        f"{_pool(cli_run.model)}; (K1, K2) launches {launches}; "
        f"trace {size} B, its (K1, K2) kernel events over iterations 11..15 {traced}")
    return per_it, launches


# ------------------------------------------------------------------ evaluation
K1_PER_TRIPLET = 3 * 11 + 3 * 8   # test_batch: 3 content encodes, 3 decodes
EVAL_BATCH = 32
EVAL_STYLES = 3
FT_STEPS = 40                      # the classifier fine-tune's steps


def _eval_config(cfg, tmp, name, **tpu):
    """male2female on the phase-11 dataset (`tpu` changes, e.g. the dtype),
    written where the CLIs read it."""
    from aclgan_tpu_torch.config import save_config

    derived = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, synthetic=False,
                                      data_root=str(Path(tmp) / "ds")),
        tpu=dataclasses.replace(cfg.tpu, **tpu))
    path = Path(tmp) / f"{name}.yaml"
    save_config(derived, path)
    return str(path)


def _files(folder):
    return sorted(str(p.relative_to(folder)) for p in Path(folder).rglob("*") if p.is_file())


def phase_dataset(tmp):
    t0 = time.time()
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "make_dataset.py"), "--out",
                          str(Path(tmp) / "ds"), "--style", "hard", "--n", "64",
                          "--n_test", "64", "--size", "286"],
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"make_dataset.py failed ({out.returncode}): {out.stderr[-2000:]}")
    counts = {d: len(list((Path(tmp) / "ds" / d).glob("*.jpg")))
              for d in ("trainA", "trainB", "testA", "testB")}
    if set(counts.values()) != {64}:
        raise AssertionError(f"dataset: {counts}")
    log(f"[dataset] make_dataset.py --style hard: {counts} JPEGs at 286^2 in "
        f"{time.time() - t0:.1f} s")


def phase_train_inception(tmp):
    """`cli.train_inception` at 149^2, batch 32; returns the `.pt` path."""
    from aclgan_tpu_torch.cli import train_inception

    out = str(Path(tmp) / "inc.pt")
    torch.cuda.reset_peak_memory_stats()
    r = train_inception.main(["--data_root", str(Path(tmp) / "ds"), "--out", out,
                              "--steps", str(FT_STEPS), "--batch", "32", "--size", "149"])
    if not (math.isfinite(r["loss"]) and Path(out).is_file()):
        raise AssertionError(f"train_inception: {r}")
    log(f"[train_inception] InceptionV3 (2 classes), 149^2, batch 32, {FT_STEPS} steps: "
        f"{r['steps_per_second']:.2f} steps/s ({r['train_seconds']:.2f} s, the first "
        f"step's cuDNN set-up included), last loss {r['loss']:.4f}, full-set accuracy "
        f"{r['accuracy']:.4f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB; {Path(out).stat().st_size} B")
    # the step alone, on device-resident batches: CUDA events, then a profile
    from aclgan_tpu_torch.eval.inception import InceptionV3

    model = InceptionV3(num_classes=2, gen=torch.Generator().manual_seed(0)).cuda().eval()
    opt = train_inception.make_optimizer(model, 2e-4)
    x = torch.rand(32, 149, 149, 3, device="cuda")
    y = torch.randint(0, 2, (32,), device="cuda")
    ms = time_ms(lambda: train_inception.train_step(model, opt, x, y))
    log(f"[train_inception] one step at batch 32, 149^2, after warm-up: {ms:.2f} ms = "
        f"{1e3 / ms:.2f} steps/s (mean of 20, CUDA events)")
    _profile("one fine-tune step at batch 32, 149^2",
             lambda: train_inception.train_step(model, opt, x, y))
    return out


def phase_cli_test(cfg, tmp, ckpt):
    """`cli.test` in float32 on the card against the CPU; returns its
    (K1, K2) launches."""
    from aclgan_tpu_torch.cli import test as cli_test
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    path = _eval_config(cfg, tmp, "m2f_eval32", compute_dtype="float32")
    image = sorted((Path(tmp) / "ds" / "testA").glob("*.jpg"))[0]
    argv = ["--config", path, "--input", str(image), "--checkpoint", ckpt,
            "--num_style", "10", "--seed", "10"]
    K.launches = K.bwd_launches = 0
    t0 = time.time()
    card = cli_test.main(argv + ["--output_folder", str(Path(tmp) / "test_card")])
    torch.cuda.synchronize()
    card_s = time.time() - t0
    launches = (K.launches, K.bwd_launches)
    if launches != (LAUNCHES_PER_BATCH, 0):
        raise AssertionError(f"cli.test: (K1, K2) launches {launches}")
    want = ["input.jpg"] + sorted(f"output{j:03d}{x}.jpg" for j in range(10)
                                  for x in ("", "_img", "_mask"))
    if _files(Path(tmp) / "test_card") != sorted(want):
        raise AssertionError(f"cli.test files: {_files(Path(tmp) / 'test_card')}")
    t0 = time.time()
    cpu = cli_test.main(argv + ["--output_folder", str(Path(tmp) / "test_cpu"),
                                "--device", "cpu"])
    cpu_s = time.time() - t0

    def u8(x):
        return np.clip(np.rint((x + 1.0) * 127.5), 0, 255).astype(np.int16)

    diff = np.abs(u8(card["outputs"]) - u8(cpu["outputs"]))
    mask_err = float(np.abs(card["masks"] - cpu["masks"]).max())
    log(f"[cli.test] f32, one {card['outputs'].shape[1]}x{card['outputs'].shape[2]} "
        f"image, 10 styles: (K1, K2) launches {launches}, {len(want)} files in {card_s:.2f} s "
        f"(model load included); vs --device cpu: max {diff.max()} LSB, mean "
        f"{diff.mean():.5f} LSB, mask max err {mask_err:.2e} (CPU {cpu_s:.1f} s)")
    if diff.max() > 2 or not np.isfinite(card["outputs"]).all():
        raise AssertionError(f"cli.test: card differs from CPU by {diff.max()} LSB")
    return launches


def _scorer_parity(tmp, inc):
    """The scorer's features and softmax on 8 testA images, card vs CPU."""
    from aclgan_tpu_torch.data.dataset import load_image
    from aclgan_tpu_torch.eval.inception import InceptionScorer

    paths = sorted((Path(tmp) / "ds" / "testA").glob("*.jpg"))[:8]
    x = np.stack([np.asarray(load_image(str(p)), np.float32) / 255.0 for p in paths])
    card, cpu = InceptionScorer(inc), InceptionScorer(inc, device="cpu")
    f_card, f_cpu = card.features(x), cpu.features(x)
    p_card, p_cpu = card.predict(x), cpu.predict(x)
    f_err = float(np.abs(f_card - f_cpu).max() / np.abs(f_cpu).max())
    p_err = float(np.abs(p_card - p_cpu).max())
    log(f"[cli.test_batch] scorer on the card vs the CPU (8 images, 286^2 -> 299^2, "
        f"float32, TF32 off): features max err {f_err:.2e} of their largest "
        f"({np.abs(f_cpu).max():.3e}), softmax max err {p_err:.2e}")
    if f_err > 1e-3 or p_err > 1e-4:
        raise AssertionError(f"scorer card vs CPU: features {f_err:.2e} > 1e-3 or softmax "
                             f"{p_err:.2e} > 1e-4")
    return card


def _batch_rates(model, scorer, x):
    """One test_batch batch (a style triple, translation + IS + FID scoring):
    its device ms (CUDA events, median of 5), and the scorer's img/s alone."""
    from aclgan_tpu_torch.cli.test_batch import translate_triplet
    from aclgan_tpu_torch.eval.inception import full_f32, resize_299

    s = torch.full((model.cfg.gen.style_dim,), 2.0)

    def one_batch():
        bar = translate_triplet(model, x, s, s, s)[0]
        bar01 = (bar.float().cpu().numpy() + 1.0) / 2.0
        scorer.features(bar01)
        scorer.predict(bar01)

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    batch_ms = timed(one_batch)
    img = torch.rand(len(x), 3, 299, 299, device=scorer.device)
    with torch.inference_mode(), full_f32():
        fwd_ms = timed(lambda: scorer.model(img, True))
    x01 = ((x.numpy() + 1.0) / 2.0)
    call_ms = timed(lambda: scorer.features(x01))
    log(f"[cli.test_batch] one batch of {len(x)} at 256^2, one style triple + "
        f"features + softmax: {batch_ms:.2f} ms = {1e3 * len(x) / batch_ms:.1f} img/s "
        f"(median of 5, CUDA events); the scorer at batch {len(x)}, 299^2, float32: "
        f"network {fwd_ms:.2f} ms = {1e3 * len(x) / fwd_ms:.1f} img/s, `features()` "
        f"from host 256^2 images {call_ms:.2f} ms = {1e3 * len(x) / call_ms:.1f} img/s")
    _profile(f"one test_batch batch of {len(x)} (translate_triplet + scoring)", one_batch)
    _profile(f"the scorer's `features()` at batch {len(x)} from host 256^2 images "
             "(TF32 off)", lambda: scorer.features(x01))


def phase_cli_test_batch(cfg, tmp, ckpt, inc):
    """`cli.test_batch` with IS / CIS / FID; returns its (K1, K2) launches."""
    from aclgan_tpu_torch.cli import test_batch
    from aclgan_tpu_torch.data.loader import DataLoader, ImageDataset
    from aclgan_tpu_torch.data.transforms import TransformSpec
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.trainer import ACLGAN
    from aclgan_tpu_torch.utils.checkpoint import load_generators

    path = _eval_config(cfg, tmp, "m2f_eval")
    ds, out = Path(tmp) / "ds", Path(tmp) / "test_batch"
    torch.cuda.reset_peak_memory_stats()
    K.launches = K.bwd_launches = 0
    t0 = time.time()
    r = test_batch.main(["--config", path, "--input_folder", str(ds / "testA"),
                         "--output_folder", str(out), "--checkpoint", ckpt,
                         "--batch", str(EVAL_BATCH), "--num_style", str(EVAL_STYLES),
                         "--compute_IS", "--compute_CIS", "--compute_FID",
                         "--fid_real_folder", str(ds / "testB"),
                         "--inception_weights", inc, "--inception_b", inc])
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = (K.launches, K.bwd_launches)
    n_batches = -(-64 // EVAL_BATCH)
    if launches != (K1_PER_TRIPLET * EVAL_STYLES * n_batches, 0):
        raise AssertionError(f"cli.test_batch: (K1, K2) launches {launches}")
    names = sorted(p.name for p in (ds / "testA").glob("*.jpg"))
    want = sorted([f"input{i:03d}.jpg" for i in range(64)]
                  + [f"_{j:02d}_{k}/{n}" for j in range(EVAL_STYLES) for k in ("bar", "mask")
                     for n in names])
    if _files(out) != want:
        raise AssertionError(f"cli.test_batch: {len(_files(out))} files, expected {len(want)}")
    scores = [r["IS"], r["CIS"], r["FID"]]
    if not all(math.isfinite(v) for v in scores) or r["IS"] < 1.0 - 1e-9 or r["n_images"] != 64:
        raise AssertionError(f"cli.test_batch: {r}")
    log(f"[cli.test_batch] {cfg.tpu.compute_dtype}, 64 testA images at batch {EVAL_BATCH}, {EVAL_STYLES} "
        f"styles: IS {r['IS']:.6f}, CIS {r['CIS']:.6f}, FID {r['FID']:.4f}, target-domain "
        f"rate {r['target_domain_rate']:.4f}; {launches[0]} K1 launches; {len(want)} files; "
        f"{wall:.2f} s end to end = {64 * EVAL_STYLES / wall:.2f} translations/s (start-up, "
        f"two scorers, the real side, JPEG writes and the sqrtm included); scipy sqrtm "
        f"2048^2 {r['fid_seconds']:.2f} s; peak memory {peak / 2**30:.3f} GiB ({peak} B)")

    scorer = _scorer_parity(tmp, inc)
    model = ACLGAN(cfg, device="cuda")
    load_generators(ckpt, model)
    size = cfg.data.resolved_sizes()[0]
    spec = TransformSpec(new_size=size, crop_h=size, crop_w=size, flip=False)
    loader = DataLoader(ImageDataset([str(ds / "testA" / n) for n in names], spec),
                        EVAL_BATCH, train=False)
    x, _ = next(loader.iter_padded())  # test_batch's first batch
    _batch_rates(model, scorer, torch.from_numpy(x))
    return launches


def _curve_checks(doc, iterations):
    """`cli.fid_curve`'s rows: the JAX tool's keys, finite FIDs and intervals."""
    keys = {"iteration", "fid", "target_domain_rate", "n_fake", "n_real", "fid_styles",
            "fid_spread", "fid_ci95", "fid_f32_minus_f64"}
    rows = doc["rows"]
    if [row["iteration"] for row in rows] != list(iterations) or any(set(x) != keys
                                                                     for x in rows):
        raise AssertionError(f"cli.fid_curve {doc.get('prefix')} rows: {rows}")
    vals = [v for row in rows for v in [row["fid"], row["fid_f32_minus_f64"],
                                        *row["fid_ci95"], *row["fid_styles"]]]
    if not all(math.isfinite(v) for v in vals) or not doc["complete"]:
        raise AssertionError(f"cli.fid_curve {doc.get('prefix')}: non-finite values or an "
                             f"incomplete sweep in {rows}")
    return rows


# ------------------------------------------------------------------ serving stack
BUCKETS = (128, 192, 256)
N_BUCKETED = 96
HTTP_BATCH = 16
HTTP_WAIT_MS = 5.0
HTTP_LEVELS = (1, 8, 32, 48)
HTTP_SECONDS = 3.0


def _max_lsb(got, want):
    return max(int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max())
               for g, w in zip(got, want))


def _bucketed_requests():
    """96 requests whose short sides spread over 100-320, either orientation."""
    rng = np.random.RandomState(2)
    imgs = []
    for _ in range(N_BUCKETED):
        short = int(rng.randint(100, 321))
        long = short + int(rng.randint(0, 65))
        hw = (short, long) if rng.rand() < 0.5 else (long, short)
        imgs.append(rng.randint(0, 256, hw + (3,), dtype=np.uint8))
    return imgs, rng.randn(N_BUCKETED, 8).astype(np.float32)


def phase_bucketed(cfg, ckpt):
    """`BucketedTranslator` against a plain Translator at each bucket; returns
    its K1 launches over the 96 requests."""
    from aclgan_tpu_torch.data.transforms import prep_image
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.serving import BucketedTranslator, Translator

    imgs, styles = _bucketed_requests()
    tr = BucketedTranslator(cfg, ckpt, buckets=BUCKETS, batch_size=BATCH)
    tr.warmup()
    if tr.compiled_shapes() != len(BUCKETS):
        raise AssertionError(f"bucketed: {tr.compiled_shapes()} shapes after warmup")
    groups: dict = {}
    for i, im in enumerate(imgs):
        groups.setdefault(tr.pick_bucket(im), []).append(i)
    n_batches = sum(-(-len(v) // BATCH) for v in groups.values())
    K.launches = K.bwd_launches = 0
    outs = tr(imgs, styles)
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    if launches != (LAUNCHES_PER_BATCH * n_batches, 0):
        raise AssertionError(f"bucketed: (K1, K2) launches {launches} for {n_batches} "
                             "batches")
    worst = 0
    for b, idxs in sorted(groups.items()):
        want = Translator(cfg, ckpt, batch_size=BATCH, size=b)([imgs[i] for i in idxs],
                                                              styles[idxs])
        got = [outs[i] for i in idxs]
        if any(o.shape != (b, b, 3) or o.dtype != np.uint8 for o in got):
            raise AssertionError(f"bucketed: an output of bucket {b} is not {b}x{b}x3 uint8")
        worst = max(worst, _max_lsb(got, want))
    if worst > 1:
        raise AssertionError(f"bucketed: {worst} LSB from the plain Translator")
    secs = []
    for _ in range(5):  # the whole call: resize and crop on the host, batches, copies
        t0 = time.perf_counter()
        tr(imgs, styles)
        secs.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for im in imgs:
        prep_image(im, tr.pick_bucket(im))
    prep_s = time.perf_counter() - t0
    if tr.compiled_shapes() != len(BUCKETS):
        raise AssertionError(f"bucketed: {tr.compiled_shapes()} shapes after repeat traffic")
    p50 = float(np.median(secs))
    log(f"[bucketed] buckets {BUCKETS}, batch {BATCH}, {cfg.tpu.compute_dtype}: "
        f"{N_BUCKETED} requests "
        f"(short sides 100-320) -> {', '.join(f'{b}: {len(v)}' for b, v in sorted(groups.items()))}"
        f", {n_batches} device batches, (K1, K2) launches {launches}; vs the plain Translator at "
        f"each bucket: max {worst} LSB; compiled_shapes {tr.compiled_shapes()} after warmup "
        f"and repeat traffic; p50 {N_BUCKETED / p50:.1f} img/s over 5 calls "
        f"({', '.join(f'{N_BUCKETED / x:.1f}' for x in secs)}), host clock; resize + crop "
        f"alone {prep_s:.3f} s of the {p50:.3f} s")
    return launches


def phase_export(cfg, ckpt, tmp, outs16):
    """Export at batch 32 on the card, save, load, serve phase 6's requests;
    returns the (K1, K2) launches of those 70 requests."""
    from aclgan_tpu_torch.export import (ExportedTranslator, export_translator,
                                         kernel_nodes, save_artifact)
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.serving import Translator

    t0 = time.perf_counter()
    exported, meta = export_translator(cfg, ckpt, batch_size=BATCH, device="cuda")
    export_s = time.perf_counter() - t0
    nodes = kernel_nodes(exported)
    if nodes != LAUNCHES_PER_BATCH:
        raise AssertionError(f"export: {nodes} aclgan:: nodes in the graph")
    path = Path(tmp) / "m2f_a2b_b32.aclt"
    t0 = time.perf_counter()
    save_artifact(exported, meta, str(path))
    save_s = time.perf_counter() - t0
    del exported
    t0 = time.perf_counter()
    frozen = ExportedTranslator(str(path))
    load_s = time.perf_counter() - t0
    imgs, styles = _requests()
    K.launches = K.bwd_launches = 0
    outs, masks = frozen(imgs, styles, return_masks=True)
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    if launches != (LAUNCHES_PER_BATCH * -(-N_REQUESTS // BATCH), 0):
        raise AssertionError(f"export: (K1, K2) launches {launches} for {N_REQUESTS} "
                             "requests")
    _check_outputs(outs, masks, "export")
    worst = _max_lsb(outs, outs16)
    if worst > 1:
        raise AssertionError(f"export: {worst} LSB from phase 6's live Translator")
    live = Translator(cfg, ckpt, batch_size=BATCH)
    window, win_styles = _window(imgs, styles)
    rates = {"live": [], "exported": []}
    for turn in ("live", "exported", "exported", "live"):
        rates[turn].append(float(np.median(
            _img_rates(live if turn == "live" else frozen, window, win_styles, 5))))
    log(f"[export] batch {BATCH}, 256^2, {cfg.tpu.compute_dtype}: export_translator "
        f"{export_s:.2f} s on the card ({nodes} aclgan:: nodes), save {save_s:.2f} s, {path.stat().st_size / 1e6:.1f} "
        f"MB ({path.stat().st_size} B), load + move {load_s:.2f} s; {N_REQUESTS} requests: "
        f"(K1, K2) launches {launches}, vs phase 6's live Translator max {worst} LSB; img/s (p50 of "
        f"5 windows of {len(window)}, in turns live, exported, exported, live): live "
        f"{', '.join(f'{r:.1f}' for r in rates['live'])}, exported "
        f"{', '.join(f'{r:.1f}' for r in rates['exported'])}")
    return launches


class _Recording:
    """A translator proxy that records each device call's batch (the
    coalesced batch before padding), as `tools/bench_serving.py` does, and
    its host seconds (the worker's time inside the call, copies included)."""

    def __init__(self, inner):
        self._inner = inner
        self.batch_sizes, self.seconds = [], []

    def __call__(self, images, styles=None, **kw):
        self.batch_sizes.append(len(images))
        t0 = time.perf_counter()
        out = self._inner(images, styles=styles, **kw)
        self.seconds.append(time.perf_counter() - t0)
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _http_clients(port, bodies, concurrency, seconds, out):
    """Closed-loop clients (runs in a spawned process): `concurrency` threads
    each POST one body, wait for the reply, and go again until the deadline.
    Puts (latencies in s, errors, elapsed s) on `out`."""
    import http.client
    import threading

    lat, errors, lock = [], [], threading.Lock()
    stop_at = time.monotonic() + seconds

    def client(k):
        mine, i = [], k
        while time.monotonic() < stop_at:
            t0 = time.monotonic()
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                conn.request("POST", "/translate", body=bodies[i % len(bodies)],
                             headers={"Content-Type": "image/jpeg"})
                r = conn.getresponse()
                data = r.read()
                conn.close()
                if r.status != 200 or not data.startswith(b"\xff\xd8"):
                    raise RuntimeError(f"status {r.status}: {data[:200]!r}")
            except Exception as e:
                with lock:
                    errors.append(repr(e))
                continue
            mine.append(time.monotonic() - t0)
            i += concurrency
        with lock:
            lat.extend(mine)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out.put((lat, errors, time.monotonic() - t0))


def _http_level(port, bodies, concurrency, rec, tag):
    """One closed-loop level against a serving port; returns its numbers."""
    import multiprocessing

    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    rec.batch_sizes.clear()
    rec.seconds.clear()
    K.launches = K.bwd_launches = 0
    proc = ctx.Process(target=_http_clients,
                       args=(port, bodies, concurrency, HTTP_SECONDS, q))
    proc.start()
    try:
        lat, errors, elapsed = q.get(timeout=HTTP_SECONDS + 120)
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
    torch.cuda.synchronize()
    batches, call_s = list(rec.batch_sizes), list(rec.seconds)
    if errors:
        raise AssertionError(f"http {tag} c{concurrency}: {len(errors)} errors, first "
                             f"{errors[0]}")
    if not lat or (K.launches, K.bwd_launches) != (LAUNCHES_PER_BATCH * len(batches), 0):
        raise AssertionError(f"http {tag} c{concurrency}: {len(lat)} replies, (K1, K2) "
                             f"launches {(K.launches, K.bwd_launches)} for {len(batches)} "
                             "device batches")
    ms = np.asarray(sorted(lat)) * 1e3
    row = dict(mode=tag, concurrency=concurrency, requests=len(lat),
               img_s=len(lat) / elapsed, p50_ms=float(np.percentile(ms, 50)),
               p99_ms=float(np.percentile(ms, 99)),
               mean_batch=float(np.mean(batches)), device_batches=len(batches),
               call_p50_ms=float(np.median(call_s)) * 1e3,
               worker_busy=float(sum(call_s)) / elapsed, k1_launches=K.launches,
               k2_launches=K.bwd_launches, errors=0)
    log(f"[http] {tag}, concurrency {concurrency}: {row['img_s']:.1f} img/s, p50 "
        f"{row['p50_ms']:.1f} ms, p99 {row['p99_ms']:.1f} ms, mean coalesced batch "
        f"{row['mean_batch']:.2f} ({len(batches)} device batches, {K.launches} K1 "
        f"launches), {len(lat)} requests in {elapsed:.2f} s, 0 errors; a translator call "
        f"p50 {row['call_p50_ms']:.1f} ms, the worker inside calls "
        f"{100 * row['worker_busy']:.1f}% of the level")
    return row


def _jpeg_bodies(n=16):
    """256^2 JPEG request bodies of photo-like size (smooth images, quality 90)."""
    from PIL import Image

    rng = np.random.RandomState(3)
    bodies = []
    for _ in range(n):
        small = Image.fromarray(rng.randint(0, 256, (16, 16, 3), dtype=np.uint8))
        buf = io.BytesIO()
        small.resize((256, 256), Image.BICUBIC).save(buf, format="JPEG", quality=90)
        bodies.append(buf.getvalue())
    return bodies


def _serve(httpd):
    import threading

    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return thread


def _shutdown(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    httpd.aclgan_async.close(drain=False)
    thread.join(timeout=10)


def phase_http(cfg, ckpt, tmp):
    """The HTTP front over a Translator, then over an exported artifact;
    returns the (K1, K2) launches of every level together."""
    import urllib.request

    from aclgan_tpu_torch.cli import export as cli_export
    from aclgan_tpu_torch.serving import Translator
    from aclgan_tpu_torch.serving_http import make_server, server_from_argv

    bodies = _jpeg_bodies()
    rec = _Recording(Translator(cfg, ckpt, batch_size=HTTP_BATCH))
    httpd = make_server(rec, port=0, max_wait_ms=HTTP_WAIT_MS)
    if httpd.request_queue_size != 128:
        raise AssertionError(f"http: listen backlog {httpd.request_queue_size}")
    port, thread = httpd.server_address[1], _serve(httpd)
    rows = []
    try:
        for body in bodies[:3]:  # warm-up: cuDNN set-up at batch 16
            req = urllib.request.Request(f"http://127.0.0.1:{port}/translate", data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                r.read()
        for c in HTTP_LEVELS:
            rows.append(_http_level(port, bodies, c, rec, "checkpoint"))
    finally:
        _shutdown(httpd, thread)

    art = str(Path(tmp) / f"m2f_a2b_b{HTTP_BATCH}.aclt")
    t0 = time.perf_counter()
    cli_export.main(["--config", str(CONFIG), "--checkpoint", ckpt, "--output", art,
                     "--batch", str(HTTP_BATCH)])
    export_s = time.perf_counter() - t0
    httpd = server_from_argv(["--artifact", art, "--port", "0", "--max_wait_ms",
                              str(HTTP_WAIT_MS)])
    rec = httpd.aclgan_async.translator = _Recording(httpd.aclgan_async.translator)
    port, thread = httpd.server_address[1], _serve(httpd)
    try:
        for body in bodies[:3]:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/translate", data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                r.read()
        rows.append(_http_level(port, bodies, 8, rec, "artifact"))
    finally:
        _shutdown(httpd, thread)
    log(f"[http] batch {HTTP_BATCH}, {HTTP_WAIT_MS} ms window, {HTTP_SECONDS} s a level, "
        f"bodies {min(map(len, bodies))}-{max(map(len, bodies))} B; cli.export at batch "
        f"{HTTP_BATCH} {export_s:.2f} s; rows {json.dumps(rows)}")
    return (sum(r["k1_launches"] for r in rows), sum(r["k2_launches"] for r in rows))


# ------------------------------------------------------------------ training options
K1_ENCODE, K1_DECODE = 11, 8      # IN layers of a content encode, AdaIN of a decode
REMAT_EXTRA = {"none": 0, "decode": 2 * K1_DECODE, "encode": 3 * K1_ENCODE,
               "all": 3 * K1_ENCODE + 2 * K1_DECODE}  # recomputed K1 a G step


def _variant_cfg(cfg, size, dis=None, **tpu):
    """Phase 7's cut (f32, `size`^2, smooth focus terms) with dis / tpu changes."""
    return dataclasses.replace(
        cfg, focus_delta=0.0, focus_epsilon=10.0,
        dis=dataclasses.replace(cfg.dis, **(dis or {})),
        tpu=dataclasses.replace(cfg.tpu, compute_dtype="float32", **tpu),
        data=dataclasses.replace(cfg.data, crop_image_height=size, crop_image_width=size))


def _collections(model):
    """The discriminators' buffers: sn u / v and bn running stats, on the CPU."""
    from aclgan_tpu_torch.trainer import DIS_NAMES

    return {f"{n}/{k}": v.detach().float().cpu() for n in DIS_NAMES
            for k, v in model.dis(n).state_dict().items()
            if k.endswith(("weight_u", "weight_v", "running_mean", "running_var"))}


def phase_variants_f32(cfg):
    """[variants_f32] One D+G iteration on the card against the CPU for sn +
    nsgan, bn (batch 4), remat all + grad_accum 2 (batch 4) and bf16 moments,
    at phase 7's cut and tolerances. Returns {variant: (K1, K2)}."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    size = 128
    variants = {
        "sn_nsgan": (_variant_cfg(cfg, size, dis=dict(norm="sn", gan_type="nsgan")), 2, 1),
        # batch 4: bn's batch stats over 2 samples of the deepest 2x2 rows are
        # ill-conditioned enough to take card-vs-CPU gradients near 1e-2
        "bn": (_variant_cfg(cfg, size, dis=dict(norm="bn")), 4, 1),
        "remat_all_accum2": (_variant_cfg(cfg, size, remat="all", grad_accum=2), 4, 2),
        "moments_bf16": (_variant_cfg(cfg, size, moment_dtype="bfloat16"), 2, 1),
    }
    counts = {}
    for name, (vcfg, b, accum) in variants.items():
        t0 = time.time()
        rng = np.random.RandomState(5)
        xa, xb = (rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8) for _ in range(2))
        z = {k: [rng.randn(b, vcfg.gen.style_dim).astype(np.float32) for _ in range(3)]
             for k in ("dis", "gen")}

        def run(device):
            model = _train_model(vcfg, device)
            K.launches = K.bwd_launches = 0
            m = model.train_step(xa, xb, True, True, z=z)
            out = {k: float(v) for k, v in m.items()}
            launched = (K.launches, K.bwd_launches)
            return out, launched, _grads(model), _collections(model)

        got, launched, got_grads, got_col = run("cuda")
        want_counts = (accum * (2 * K1_PER_STEP + (REMAT_EXTRA["all"] if "remat" in name
                                                   else 0)), accum * K2_PER_G_STEP)
        if launched != want_counts:
            raise AssertionError(f"variants {name}: (K1, K2) {launched}, expected {want_counts}")
        want, cpu_counts, want_grads, want_col = run("cpu")
        if cpu_counts != (0, 0):
            raise AssertionError(f"variants {name}: the CPU run launched kernels")
        worst = max(abs(got[k] - w) / max(abs(w), 1e-12) for k, w in want.items())
        if set(got) != set(want) or worst > 1e-3 or not all(map(math.isfinite, got.values())):
            raise AssertionError(f"variants {name}: metrics max rel {worst:.2e} > 1e-3")
        grad_err = {n: float((got_grads[n] - want_grads[n]).norm()
                             / want_grads[n].norm().clamp_min(1e-30)) for n in want_grads}
        if max(grad_err.values()) > 1e-2:
            raise AssertionError(f"variants {name}: gradients rel-L2 {grad_err} > 1e-2")
        # the G step's bn batch mean carries the conv bias before the bn, whose
        # gradient the bn cancels: Adam's first step moves it by up to lr with
        # the sign of float noise, on each side; a tenth reaches running_mean
        slack = {k: 0.2 * vcfg.lr if k.endswith("running_mean") else 0.0 for k in want_col}
        col_raw = {k: float((got_col[k] - w).abs().max()) for k, w in want_col.items()}
        col_err = max((max(col_raw[k] - slack[k], 0.0) / float(w.abs().max().clamp_min(1e-30))
                       for k, w in want_col.items()), default=0.0)
        if ("sn" in name or name == "bn") and not want_col or col_err > 1e-3:
            worst_keys = sorted(col_raw, key=col_raw.get)[-3:]
            raise AssertionError(f"variants {name}: u / v or running stats rel {col_err:.2e} "
                                 f"beyond the bias slack; largest abs differences "
                                 f"{[(k, col_raw[k]) for k in worst_keys]}")
        counts[name] = launched
        log(f"[variants_f32] {name}: male2female full width, {size}^2, batch {b}, one D+G "
            f"iteration; (K1, K2) {launched}; vs CPU: metrics max rel {worst:.2e}, gradients "
            f"rel-L2 " + ", ".join(f"{n} {e:.2e}" for n, e in grad_err.items())
            + f", {len(want_col)} u/v or stat tensors max rel {col_err:.2e} (largest abs "
            f"difference {max(col_raw.values(), default=0.0):.2e}) "
            f"({time.time() - t0:.1f} s)")
    return counts


def gc_collect():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _rate(model, batches, cadence_start, windows=3, window=6):
    """p50 it/s of `model.train_step` at D1/G2 over `windows` windows (CUDA
    events) after two D and two D+G warm-up iterations (each key's eager
    call and its capture)."""
    it = cadence_start

    def iteration():
        nonlocal it
        xa, xb = batches[it % len(batches)]
        model.train_step(xa, xb, True, it % 2 == 0)
        it += 1

    for _ in range(4):
        iteration()
    rates = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(window):
            iteration()
        end.record()
        torch.cuda.synchronize()
        rates.append(window / (start.elapsed_time(end) / 1e3))
    return float(np.median(rates)), rates


def _train_probe(cfg, b, tag):
    """A fresh bf16 model at batch b: the (K1, K2) of its first D+G iteration,
    p50 it/s, peak memory; an out-of-memory error is reported as such."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(1)
    batches = [tuple(torch.from_numpy(rng.randint(0, 256, (b, 256, 256, 3), dtype=np.uint8))
                     .cuda() for _ in range(2)) for _ in range(2)]
    model = None
    try:
        model = _train_model(cfg, "cuda")
        K.launches = K.bwd_launches = 0
        model.train_step(*batches[0], True, True)
        torch.cuda.synchronize()
        launched = (K.launches, K.bwd_launches)
        p50, rates = _rate(model, batches, 1, *((3, 6) if b <= TRAIN_BATCH else (2, 2)))
        peak = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError as e:
        peak = torch.cuda.max_memory_allocated()
        log(f"[remat_bf16] {tag}, batch {b}: out of memory (peak allocated before it "
            f"{peak / 2**30:.3f} GiB): {str(e).splitlines()[0][:160]}")
        del model, batches
        gc_collect()
        return None
    opt_bytes = sum(t.numel() * t.element_size() for o in (model.gen_opt, model.dis_opt)
                    for st in o.state.values() for t in st.values()
                    if isinstance(t, torch.Tensor))
    log(f"[remat_bf16] {tag}, batch {b}: p50 {p50:.3f} it/s = {p50 * b:.2f} img/s "
        f"({', '.join(f'{r:.3f}' for r in rates)}); peak memory {peak / 2**30:.3f} GiB "
        f"({peak} B), the graphs' pool {_pool(model)}; (K1, K2) of a D+G iteration "
        f"{launched}; optimizer state "
        f"{opt_bytes} B")
    del model, batches
    gc_collect()
    return dict(it_s=p50, peak=peak, launches=launched, opt_bytes=opt_bytes)


def phase_remat_bf16(cfg):
    """[remat_bf16] The shipped config (bf16, 256^2) at batch 16 under each
    tpu.remat family (remat none: float32 moments), then BIG_BATCH under remat
    all and under grad_accum 4, then bf16 moments at 16. Returns {path: (K1,
    K2)}. (Without either, BIG_BATCH runs out of memory: `tools/torch_graphs.py
    batch` finds each form's largest batch in a process of its own.)"""
    b = TRAIN_BATCH
    counts, probes = {}, {}
    for remat in ("none", "decode", "encode", "all"):
        r = probes[remat] = _train_probe(dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, remat=False if remat == "none" else remat)), b, f"remat {remat}")
        want = (2 * K1_PER_STEP + REMAT_EXTRA[remat], K2_PER_G_STEP)
        if r is None or r["launches"] != want:
            raise AssertionError(f"remat_bf16 {remat}: {r}, expected launches {want}")
        counts[f"remat {remat}"] = r["launches"]
    for tag, tpu in (("remat all", dict(remat="all")), ("grad_accum 4", dict(grad_accum=4))):
        log(f"[remat_bf16] before {tag} at batch {BIG_BATCH}: device memory free "
            f"{torch.cuda.mem_get_info()[0] / 2**30:.3f} GiB, reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.3f}")
        r = _train_probe(dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, **tpu)),
                         BIG_BATCH, tag)
        if r is None:
            raise AssertionError(f"remat_bf16: {tag} at batch {BIG_BATCH} did not fit")
        accum = tpu.get("grad_accum", 1)
        want = (accum * (2 * K1_PER_STEP + REMAT_EXTRA["all" if "remat" in tpu else "none"]),
                accum * K2_PER_G_STEP)
        if r["launches"] != want:
            raise AssertionError(f"remat_bf16 {tag} at {BIG_BATCH}: launches {r['launches']}")
        counts[f"{tag}, batch {BIG_BATCH}"] = r["launches"]
    f32 = probes["none"]  # the shipped config: no remat, float32 moments
    bf16 = _train_probe(dataclasses.replace(cfg, tpu=dataclasses.replace(
        cfg.tpu, moment_dtype="bfloat16")), b, "moments bfloat16")
    log(f"[remat_bf16] optimizer state at batch {b}: bf16 moments {bf16['opt_bytes']} B "
        f"against float32 {f32['opt_bytes']} B ({bf16['opt_bytes'] / f32['opt_bytes']:.4f}); "
        f"it/s {bf16['it_s']:.3f} against {f32['it_s']:.3f}")
    counts["moments bfloat16"] = bf16["launches"]
    return counts


def _snapshot_tensors(model):
    """{path: tensor} of everything a snapshot set holds, on the CPU."""
    snap = model.snapshot()
    out = {}
    for key in ("gen", "dis", "ema"):
        out.update({f"{key}/{p}": t for p, t in _leaves(snap[key]).items()})
    for key in ("gen_opt", "dis_opt"):
        out.update({f"{key}/{p}": t for p, t in _leaves(snap[key]["state"]).items()})
    return {k: v.detach().cpu() for k, v in out.items()}


def phase_jax_resume(cfg, tmp):
    """[jax_resume] A bf16 run at batch 16 with EMA written as a JAX-layout
    snapshot set (`save_jax_checkpoint`: msgpack writer + inverse maps),
    resumed bit-equal; the next step matches the writer's; `cli.train
    --resume` continues it; `cli.convert` turns its gen/dis and a port `.pt`
    snapshot into an import the CLI resumes. Returns {path: (K1, K2)}."""
    from aclgan_tpu_torch.cli import convert as cli_convert
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.trainer import ACLGAN
    from aclgan_tpu_torch.utils.checkpoint import resume, save_jax_checkpoint

    b = TRAIN_BATCH
    derived, path = _cli_config(cfg, tmp, "m2f_jax", batch_size=b,
                                tpu=dataclasses.replace(cfg.tpu, ema_decay=0.999))
    ckpt_dir = Path(tmp) / "jaxrun" / "outputs" / "m2f_jax" / "checkpoints"
    writer = _train_model(derived, "cuda")
    rng = np.random.RandomState(7)
    batches = [tuple(rng.randint(0, 256, (b, 256, 256, 3), dtype=np.uint8) for _ in range(2))
               for _ in range(4)]
    for it, (xa, xb) in enumerate(batches[:3]):
        writer.train_step(xa, xb, True, it % 2 == 0)
    save_jax_checkpoint(str(ckpt_dir), writer, iterations=2)
    files = sorted(p.name for p in ckpt_dir.iterdir())
    if files != ["dis_00000003.msgpack", "ema_00000003.msgpack", "gen_00000003.msgpack",
                 "optimizer.msgpack"]:
        raise AssertionError(f"jax_resume: wrote {files}")
    reader = ACLGAN(derived, device="cuda", seed=derived.seed + 5)
    reader.init_state()
    if resume(str(ckpt_dir), reader) != 3:
        raise AssertionError("jax_resume: the set is not iteration 3")
    want, got = _snapshot_tensors(writer), _snapshot_tensors(reader)
    restored_step = reader.step
    if set(got) != set(want) or reader.step != writer.step:
        raise AssertionError(f"jax_resume: entries differ by {sorted(set(got) ^ set(want))[:5]}"
                             f", step {reader.step} vs {writer.step}")
    unequal = [k for k, w in want.items()
               if got[k].dtype != w.dtype or not torch.equal(got[k], w)]
    if unequal:
        raise AssertionError(f"jax_resume: {len(unequal)} tensors differ, first {unequal[:3]}")
    xa, xb = batches[3]
    z = {k: [rng.randn(b, derived.gen.style_dim).astype(np.float32) for _ in range(3)]
         for k in ("dis", "gen")}
    outs = []
    for model in (writer, reader):
        m = model.train_step(xa, xb, True, True, z=z)
        outs.append(({k: float(v) for k, v in m.items()}, _grads(model)))
    worst = max(abs(outs[1][0][k] - w) / max(abs(w), 1e-12) for k, w in outs[0][0].items())
    grad_err = {n: float((outs[1][1][n] - w).norm() / w.norm().clamp_min(1e-30))
                for n, w in outs[0][1].items()}
    if worst > 1e-3 or max(grad_err.values()) > 1e-2:
        raise AssertionError(f"jax_resume: next step metrics rel {worst:.2e}, gradients "
                             f"{grad_err}")
    log(f"[jax_resume] bf16 batch {b}, EMA 0.999: 3 iterations written as a JAX set "
        f"({', '.join(files)}); resumed: {len(want)} tensors bit-equal, step {restored_step}; "
        f"next step on injected z: metrics max rel {worst:.2e}, gradients rel-L2 "
        + ", ".join(f"{n} {e:.2e}" for n, e in grad_err.items()))
    del writer, reader, outs
    gc_collect()

    cadence = _cadence(derived, max(64, b * 8) // b, 4, 8)
    K.launches = K.bwd_launches = 0
    _run_cli(["--config", path, "--output_path", str(Path(tmp) / "jaxrun"), "--resume",
              "--max_iter", "8"])
    torch.cuda.synchronize()
    resumed = (K.launches, K.bwd_launches)
    if resumed != _expected_launches(cadence, samples=0):
        raise AssertionError(f"jax_resume: CLI launches {resumed}")
    counts = {f"train CLI --resume of a JAX set, 5 iterations at batch {b}": resumed}
    _check_records(_records(Path(tmp) / "jaxrun" / "logs" / "m2f_jax"), range(4, 9),
                   "jax_resume CLI")

    imp = Path(tmp) / "imported" / "outputs" / "m2f_jax" / "checkpoints"
    t0 = time.time()
    cli_convert.main(["--config", path, "--gen", str(ckpt_dir / "gen_00000003.msgpack"),
                      "--dis", str(ckpt_dir / "dis_00000003.msgpack"), "--output_dir",
                      str(imp)])
    convert_s = time.time() - t0
    pt_out = Path(tmp) / "converted_pt"
    cli_convert.main(["--config", path, "--gen", str(ckpt_dir / "gen_00000008.pt"),
                      "--dis", str(ckpt_dir / "dis_00000008.pt"), "--output_dir",
                      str(pt_out)])
    for kind in ("gen", "dis"):
        a = torch.load(ckpt_dir / f"{kind}_00000008.pt", weights_only=True)
        c = torch.load(pt_out / f"{kind}_00000008.pt", weights_only=True)
        if any(not torch.equal(a[n][k], c[n][k]) for n in a for k in a[n]):
            raise AssertionError(f"jax_resume: cli.convert changed the port's {kind} .pt")
    K.launches = K.bwd_launches = 0
    _run_cli(["--config", path, "--output_path", str(Path(tmp) / "imported"), "--resume",
              "--max_iter", "6"])
    torch.cuda.synchronize()
    imported = (K.launches, K.bwd_launches)
    if imported != _expected_launches(_cadence(derived, max(64, b * 8) // b, 4, 6), 0):
        raise AssertionError(f"jax_resume: imported CLI launches {imported}")
    counts[f"train CLI --resume of a cli.convert import, 3 iterations at batch {b}"] = imported
    _check_records(_records(Path(tmp) / "imported" / "logs" / "m2f_jax"), range(4, 7),
                   "jax_resume imported CLI")
    opt = torch.load(imp / "optimizer.pt", weights_only=True)
    if int(opt["gen"]["state"][0]["step"]) != 2 or opt["step"] != 6:
        raise AssertionError(f"jax_resume: the import did not start fresh moments: {opt['step']}")
    log(f"[jax_resume] cli.train --resume of the JAX set to 8: (K1, K2) {resumed}, finite "
        f"records 4..8; cli.convert of its gen/dis msgpack {convert_s:.2f} s, and of the "
        f"CLI's gen/dis_00000008.pt (unchanged); the import resumed with fresh moments to 6: "
        f"(K1, K2) {imported}, finite records 4..6")
    return counts


# ------------------------------------------------------------------ slice 7
DECODE_EPOCHS = 5                # timed epochs of phase 11's 64 trainA JPEGs
DP_WORLD, DP_BATCH = 2, 4        # [dp_two_ranks]: ranks on the one card, global batch
DDP_ITERS, DDP_RESUME_TO = 30, 35
VGG_BATCH, VGG_SIZE = 16, 256


def _decode_rate(paths, spec, use_native, workers):
    """img/s of the port's loader (uint8 batches of TRAIN_BATCH, `workers`
    threads) over DECODE_EPOCHS epochs of `paths`, after one warm-up epoch
    (host clock); and whether JPEGs went through the native core."""
    from aclgan_tpu_torch.data.loader import DataLoader, ImageDataset

    ds = ImageDataset(paths, spec, use_native=use_native)
    loader = DataLoader(ds, TRAIN_BATCH, train=True, num_workers=workers, seed=0,
                        emit="uint8")
    for _ in loader:
        pass
    n, t0 = 0, time.perf_counter()
    for _ in range(DECODE_EPOCHS):
        for batch in loader:
            n += len(batch)
    return n / (time.perf_counter() - t0), ds.native


def phase_native(cfg, tmp, synthetic_s_per_it):
    """[native] Build the port's libjpeg decode core; decode phase 11's JPEGs
    through the loader with the core on (when it built) and off; then the
    train CLI at batch 16 for 30 iterations on that folder against phase
    10's synthetic run. Returns the CLI run's (K1, K2)."""
    from aclgan_tpu_torch.data import native
    from aclgan_tpu_torch.data.transforms import TransformSpec
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    headers = Path("/usr/include/jpeglib.h").exists()
    t0 = time.time()
    built = native.build()
    log(f"[native] /usr/include/jpeglib.h {'present' if headers else 'absent'}; decode "
        f"core {'built: ' + str(built.relative_to(ROOT)) if built else 'not built'} "
        f"({time.time() - t0:.2f} s)")
    if headers and built is None:
        raise AssertionError("native: libjpeg's headers are present and the core did not build")
    if built is not None and not native.available():
        raise AssertionError(f"native: {built} built and does not load")
    ds_root = Path(tmp) / "ds"
    paths = sorted(str(p) for p in (ds_root / "trainA").glob("*.jpg"))
    spec = TransformSpec(cfg.data.new_size, cfg.data.crop_image_height,
                         cfg.data.crop_image_width, True)
    rates = {}
    for on in ([True] if built else []) + [False]:
        for workers in (1, cfg.data.num_workers):
            rate, used = _decode_rate(paths, spec, on, workers)
            if used != on:
                raise AssertionError(f"native: use_native={on} decoded natively={used}")
            rates[f"{'native core' if on else 'Pillow'}, {workers} worker(s)"] = rate
    log(f"[native] loader on {len(paths)} JPEGs at 286^2 -> {spec.crop_h}^2 (resize, crop, "
        f"flip), batch {TRAIN_BATCH}, {DECODE_EPOCHS} epochs, {os.cpu_count()} host cores: "
        + ", ".join(f"{k} {v:.1f} img/s" for k, v in rates.items()))

    b = TRAIN_BATCH
    derived = dataclasses.replace(cfg, batch_size=b, data=dataclasses.replace(
        cfg.data, synthetic=False, data_root=str(ds_root)))
    path = Path(tmp) / "m2f_jpeg.yaml"
    from aclgan_tpu_torch.config import save_config

    save_config(derived, path)
    out = Path(tmp) / "jpeg"
    epoch_len = len(paths) // b
    cadence = _cadence(derived, epoch_len, 1, 30)
    K.launches = K.bwd_launches = 0
    lines, _ = _run_cli(["--config", str(path), "--output_path", str(out), "--max_iter",
                         "30"])
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    want = _expected_launches(cadence, samples=0)
    if launches != want:
        raise AssertionError(f"native: train CLI on JPEGs (K1, K2) {launches}, expected {want}")
    _check_records(_records(out / "logs" / "m2f_jpeg"), range(1, 31), "train CLI on JPEGs")
    p50, per_it, counts = _cli_seconds(lines, cadence, {1})
    log(f"[native] train CLI on the JPEG folder ({'native core' if built else 'Pillow'}), "
        f"256^2 batch {b}, {epoch_len} batches an epoch: p50 D+G {p50['D+G']:.4f} s, D "
        f"{p50['D']:.4f} s ({counts} iterations), {per_it:.4f} s per iteration = "
        f"{b / per_it:.2f} img/s; synthetic (phase 10) {synthetic_s_per_it:.4f} s: ratio "
        f"{per_it / synthetic_s_per_it:.4f}; (K1, K2) launches {launches}")
    return launches


def _dp_rank(rank, world, port, cases, out_dir):
    """One rank of [dp_two_ranks], in its own process on the one card: joins a
    gloo group, then for each case one D+G iteration on its rows of the global
    batch, with the global z injected; saves its metrics, (K1, K2), gradients,
    parameters and bn buffers."""
    import torch.distributed as dist

    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_state
    from aclgan_tpu_torch.trainer import ACLGAN
    from torch_ranks import group_timeout

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=group_timeout())
    try:
        mesh = make_mesh(-1)
        for name, vcfg, xa, xb, z in cases:
            model = ACLGAN(vcfg, device="cuda", mesh=mesh)
            model.init_state()
            shard_state(model, mesh)
            rows = batch_sharding(mesh, xa.shape[0])
            K.launches = K.bwd_launches = 0
            m = model.train_step(xa[rows], xb[rows], True, True, z=z)
            torch.save({"metrics": {k: float(v) for k, v in m.items()},
                        "launches": (K.launches, K.bwd_launches), "grads": _grads(model),
                        "params": _params(model), "collections": _collections(model)},
                       Path(out_dir) / f"{name}.{rank}.pt")
            del model
    finally:
        dist.destroy_process_group()


def _params(model):
    from aclgan_tpu_torch.trainer import DIS_NAMES, GEN_NAMES

    nets = [(n, model.gen(n)) for n in GEN_NAMES] + [(n, model.dis(n)) for n in DIS_NAMES]
    return {n: torch.cat([p.detach().double().flatten().cpu() for p in net.parameters()])
            for n, net in nets}


def _spawn(fn, world, args, deadline, out_dir):
    """fn(rank, world, port, *args) in `world` spawned ranks under one
    deadline (`torch_ranks.spawn`): a rank still running near
    it writes its Python stack and its collective log under out_dir/dumps and
    exits, and the phase fails with every rank's."""
    from torch_ranks import spawn

    spawn(fn, world, args, timeout=deadline, dump_dir=Path(out_dir) / "dumps")


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def phase_dp_two_ranks(cfg, tmp):
    """[dp_two_ranks] Two processes on the one card over gloo with CUDA
    tensors, one D+G iteration at phase 7's cut (f32, TF32 off, 128^2, global
    batch 4, 2 a rank) for dis in and dis bn, against the single-process step
    at batch 4. Returns {case: (K1, K2) of each rank}."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    size, b = 128, DP_BATCH
    rng = np.random.RandomState(7)
    cases = []
    for norm in ("in", "bn"):
        vcfg = _variant_cfg(cfg, size, dis=dict(norm=norm))
        xa, xb = (torch.from_numpy(rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8))
                  for _ in range(2))
        z = {k: [rng.randn(b, vcfg.gen.style_dim).astype(np.float32) for _ in range(3)]
             for k in ("dis", "gen")}
        cases.append((f"dis_{norm}", vcfg, xa, xb, z))
    out_dir = Path(tmp) / "dp"
    out_dir.mkdir()
    t0 = time.time()
    _spawn(_dp_rank, DP_WORLD, (cases, str(out_dir)), 300, out_dir)
    ranks_s = time.time() - t0
    counts = {}
    for name, vcfg, xa, xb, z in cases:
        ranks = [torch.load(out_dir / f"{name}.{r}.pt", weights_only=True)
                 for r in range(DP_WORLD)]
        model = _train_model(vcfg, "cuda")
        K.launches = K.bwd_launches = 0
        m = model.train_step(xa, xb, True, True, z=z)
        want = {k: float(v) for k, v in m.items()}
        single_counts = (K.launches, K.bwd_launches)
        want_grads, want_params, want_col = _grads(model), _params(model), _collections(model)
        del model
        r0, r1 = ranks
        if r0["launches"] != r1["launches"] or r0["launches"] != single_counts:
            raise AssertionError(f"dp {name}: (K1, K2) ranks {r0['launches']} / "
                                 f"{r1['launches']}, single process {single_counts}")
        worst = max(abs(r0["metrics"][k] - w) / max(abs(w), 1e-12) for k, w in want.items())
        if set(r0["metrics"]) != set(want) or worst > 1e-4:
            raise AssertionError(f"dp {name}: metrics max rel {worst:.2e} > 1e-4")
        param_err = {n: _rel(r0["params"][n], w) for n, w in want_params.items()}
        # reported, not gated: under dis in the deepest scale normalizes 2x2
        # rows, whose gradients carry float noise near 1e-2 rel-L2 (phase 19)
        grad_err = {n: _rel(r0["grads"][n], w) for n, w in want_grads.items()}
        if max(param_err.values()) > 1e-3:
            raise AssertionError(f"dp {name}: params rel-L2 {param_err} > 1e-3")
        same = all(torch.equal(r0[key][n], r1[key][n]) for key in ("params", "collections")
                   for n in r0[key])
        if not same:
            raise AssertionError(f"dp {name}: the ranks' parameters or buffers differ")
        # bn's running_mean: the conv bias before a bn moves by +-lr with the
        # sign of float noise (phase 19); a tenth reaches the running mean
        col = {k: float((r0["collections"][k] - w).abs().max()
                        - (0.2 * vcfg.lr if k.endswith("running_mean") else 0.0))
               / float(w.abs().max().clamp_min(1e-30)) for k, w in want_col.items()}
        col_err = max(col.values(), default=0.0)
        if (name == "dis_bn") != bool(want_col) or col_err > 1e-3:
            raise AssertionError(f"dp {name}: running stats rel {col_err:.2e} beyond the slack")
        counts[name] = r0["launches"]
        log(f"[dp_two_ranks] {name}: male2female full width, {size}^2, global batch {b} over "
            f"{DP_WORLD} ranks on one card (gloo, CUDA tensors), one D+G iteration; (K1, K2) "
            f"each rank {r0['launches']}; vs one process at batch {b}: metrics max rel "
            f"{worst:.2e}, params rel-L2 max {max(param_err.values()):.2e}, gradients "
            f"rel-L2 " + ", ".join(f"{n} {e:.2e}" for n, e in grad_err.items())
            + f", {len(want_col)} running-stat tensors rel {col_err:.2e}; ranks equal")
    log(f"[dp_two_ranks] the two rank processes took {ranks_s:.1f} s (start, build load, "
        f"both cases)")
    return counts


def _hold_trace(what, events, launches):
    """A trace's (K1, K2) kernel events against the launches of the traced
    work. torch.profiler loses a few kernel events of a session now and then,
    in the eager form too, whose every launch its wrapper counts, so the trace
    must hold every kernel that the work launched, none that it did not, and
    no more events than launches; a shortfall is logged."""
    events, launches = tuple(events), tuple(launches)
    if any(n > want or (n == 0) != (want == 0) for n, want in zip(events, launches)):
        raise AssertionError(f"{what}: the trace holds (K1, K2) kernel events {events}, "
                             f"the traced work launches {launches}")
    if events != launches:
        log(f"[profile] {what}: torch.profiler lost (K1, K2) "
            f"{tuple(w - n for n, w in zip(events, launches))} of {launches} kernel events")


def _trace_launches(trace):
    """(K1, K2) kernel events in a chrome trace of torch.profiler."""
    events = json.loads(Path(trace).read_text()).get("traceEvents", [])
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return (sum("instance_norm_fwd" in k for k in kernels),
            sum("instance_norm_bwd" in k for k in kernels))


TORCHRUN_CLI = "--torchrun-cli"  # chip_smoke.py's own argument: phase 24's rank process
KEEP_GRAPHS = "--keep-graphs"    # after it: the CLI's release of its graphs taken out
DDP_DEADLINE = 300               # s: one torchrun run of the CLI, ranks dumped and killed after
DDP_GRIDS = (10, DDP_ITERS)      # image_display_iter, image_save_iter of phase 24's runs


def _torchrun_cli(out_json, argv):
    """A rank that torchrun starts for phase 24: `cli.train.main(argv)`, the
    train CLI as `-m aclgan_tpu_torch.cli.train` runs it, armed to dump its
    stack and exit near the run's deadline (`torch_ranks.torchrun`); then
    its form (graphed or eager), the keys its graphs ran, the (K1, K2)
    counters over the run and over the calls that replayed a captured
    train step, its `sample` calls, and the graphs left alive after `main`,
    written to `out_json` (rank r > 0: `out_json`.r). `KEEP_GRAPHS` first in
    `argv` takes the CLI's release of its graphs out (a reproduction of the
    teardown with graphs alive)."""
    sys.path.insert(0, str(ROOT))
    from aclgan_tpu_torch import graphs
    from aclgan_tpu_torch.cli.train import main as train_main
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.trainer import ACLGAN
    from torch_ranks import watch_torchrun_rank

    watch_torchrun_rank()
    if argv[:1] == [KEEP_GRAPHS]:
        argv = argv[1:]
        ACLGAN.release_graphs = lambda self: None
    replayed, samples, keys = [0, 0], [0], []
    run, sample = graphs.StepGraphs.run, ACLGAN.sample

    def counted(self, key, *args, **kwargs):
        captured = key in self._entries
        keys.extend([key] if key not in keys else [])
        before = (K.launches, K.bwd_launches)
        out = run(self, key, *args, **kwargs)
        if captured and key[0] == "train":
            replayed[0] += K.launches - before[0]
            replayed[1] += K.bwd_launches - before[1]
        return out

    def counted_sample(self, *args):
        samples[0] += 1
        return sample(self, *args)

    graphs.StepGraphs.run, ACLGAN.sample = counted, counted_sample
    model = train_main(argv).model
    rank = int(os.environ.get("RANK", "0"))
    Path(f"{out_json}.{rank}" if rank else out_json).write_text(json.dumps({
        "form": "eager" if model.graphs is None else "graphed",
        "mesh": type(model.mesh).__name__, "launches": [K.launches, K.bwd_launches],
        "replayed": replayed, "samples": samples[0], "keys": [repr(k) for k in keys],
        "left": len(model.graphs._entries) if model.graphs else 0}))
    return 0


def _hold_ranks(what, ranks, cadence, samples, release=True):
    """Each rank's counters of one torchrun run of the CLI (`_torchrun_cli`)
    against the cadence: graphed under a `DataMesh`, (K1, K2) over the run
    the cadence's count (rank 0 adds its `samples` calls of `sample`, the
    others none), those of the replayed train steps the cadence's replays,
    and no graph left alive after `main` (all of them with `release` False)."""
    steps, replays = _expected_launches(cadence, samples=0), _replayed_launches(cadence)
    for r, ran in enumerate(ranks):
        want = _expected_launches(cadence, samples) if r == 0 else steps
        n = samples if r == 0 else 0
        if (ran["form"], ran["mesh"], tuple(ran["launches"]), ran["samples"]) != \
                ("graphed", "DataMesh", want, n):
            raise AssertionError(f"{what} rank {r}: the {ran['form']} form under a "
                                 f"{ran['mesh']} launched (K1, K2) {ran['launches']} with "
                                 f"{ran['samples']} samples; the cadence {want} with {n}")
        if tuple(ran["replayed"]) != replays:
            raise AssertionError(f"{what} rank {r}: (K1, K2) under replay {ran['replayed']}, "
                                 f"the cadence {replays}")
        if (ran["left"] == 0) != release:
            raise AssertionError(f"{what} rank {r}: {ran['left']} graphs alive after main")


def phase_ddp_cli(cfg, tmp, cli_s_per_it=None, world=1, release=True, resume=True,
                  deadline=DDP_DEADLINE):
    """[ddp_cli] The train CLI under `torch.distributed.run --nproc_per_node
    world` (through `chip_smoke.py --torchrun-cli`, which runs
    `cli.train.main` and reads its counters; `torch_ranks.torchrun`, one
    deadline with every rank's dumps) with `tpu.distributed: true` (NCCL, a
    `DataMesh` of `world` ranks, one a card: the steps replay CUDA graphs
    with their all-reduces inside) on the shipped config, synthetic, global
    batch 16, bf16: 30 iterations traced at 10..14 with rank 0's grids at 10,
    20, 30 (`DDP_GRIDS`) and the final snapshot, then `--resume` to 35; s/it
    p50 against phase 10's single process when given; on every rank the
    form, the (K1, K2) counters (over the run and under replay) against the
    cadence's count and the graphs destroyed before the group (`_hold_ranks`,
    both runs); the scalars, grids and snapshot files. `release` False takes
    the CLI's release of its graphs out (a reproduction of the teardown with
    graphs alive); `resume` False leaves the resumed run out; `deadline`
    bounds each torchrun launch. Returns what it measured."""
    from torch_ranks import torchrun

    b, local = TRAIN_BATCH, TRAIN_BATCH // world
    derived, path = _cli_config(cfg, tmp, "m2f_ddp", batch_size=b, image_display_iter=DDP_GRIDS[0],
                                image_save_iter=DDP_GRIDS[1],
                                tpu=dataclasses.replace(cfg.tpu, distributed=True))
    run_dir = Path(tempfile.mkdtemp(prefix=f"ddp_w{world}_", dir=tmp))
    out, prof_dir = run_dir / "out", run_dir / "trace"
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT)] + [p for p in
                                                        [os.environ.get("PYTHONPATH")] if p])}

    def run(tag, extra):
        counters = run_dir / f"counters.{tag}.json"
        argv = [ROOT / "chip_smoke.py", TORCHRUN_CLI, counters] + ([] if release
                                                                   else [KEEP_GRAPHS])
        lines, secs = torchrun(argv + ["--config", path, "--output_path", out] + extra, world,
                               deadline, run_dir / f"dumps.{tag}", env)
        ranks = [json.loads(Path(f"{counters}.{r}" if r else counters).read_text())
                 for r in range(world)]
        return lines, secs, ranks

    lines, first_s, ranks = run("first", ["--max_iter", str(DDP_ITERS), "--profile_dir",
                                          str(prof_dir)])
    if not any(f"{world} device(s)" in line for line in lines):
        raise AssertionError(f"ddp_cli world {world}: no 'Training ... {world} device(s)' line")
    if any("steps run eagerly" in line for line in lines):
        raise AssertionError(f"ddp_cli world {world}: a rank ran its steps eagerly")
    epoch_len = max(64, local * 8) // local
    cadence = _cadence(derived, epoch_len, 1, DDP_ITERS)
    n_samples = DDP_ITERS // DDP_GRIDS[0] + 2 * (DDP_ITERS // DDP_GRIDS[1])
    _hold_ranks(f"ddp_cli world {world}", ranks, cadence, n_samples, release)
    _check_records(_records(out / "logs" / "m2f_ddp"), range(1, DDP_ITERS + 1), "ddp_cli")
    grids = sorted(p.stem for p in (out / "outputs" / "m2f_ddp" / "images").iterdir())
    if grids != [f"gen_a2b_{g}" for g in ("test_%08d" % DDP_ITERS, "train_%08d" % DDP_ITERS,
                                          "train_current")]:
        raise AssertionError(f"ddp_cli world {world}: grids {grids}")
    # set-up; the traced window (profiler on) and the iteration after it; an
    # iteration after a grid (its time holds the sampling)
    skip = {1} | set(range(11, 17)) | {g + 1 for g in range(DDP_GRIDS[0], DDP_ITERS,
                                                            DDP_GRIDS[0])}
    p50, per_it, counts = _cli_seconds(lines, cadence, skip)
    timed = sum(float(m[2]) for m in map(_ITERATION.match, lines) if m)
    traced = _trace_launches(prof_dir / "trace.json")
    window = _expected_launches({i: cadence[i] for i in range(11, 16)}, samples=0)
    _hold_trace(f"ddp_cli world {world}, iterations 11..15", traced, window)
    resume_s, again, ends = 0.0, None, (DDP_ITERS,)
    if resume:
        resumed, resume_s, again = run("resumed", ["--max_iter", str(DDP_RESUME_TO),
                                                   "--resume"])
        if not any(line == f"Resume from iteration {DDP_ITERS}" for line in resumed):
            raise AssertionError("ddp_cli: --resume did not start from the snapshot")
        _hold_ranks(f"ddp_cli world {world}, resumed", again,
                    _cadence(derived, epoch_len, DDP_ITERS + 1, DDP_RESUME_TO), 0, release)
        _check_records(_records(out / "logs" / "m2f_ddp"), range(1, DDP_RESUME_TO + 1),
                       "ddp_cli resumed")
        ends += (DDP_RESUME_TO,)
    ckpts = sorted(p.name for p in (out / "outputs" / "m2f_ddp" / "checkpoints").iterdir())
    want_ckpts = sorted(f"{k}_{i:08d}.pt" for k in ("gen", "dis") for i in ends)
    if ckpts != sorted(want_ckpts + ["optimizer.pt"]):
        raise AssertionError(f"ddp_cli: snapshot files {ckpts}")
    ran = ranks[0]
    log(f"[ddp_cli] torchrun --nproc_per_node {world}, tpu.distributed (NCCL): the "
        f"{ran['form']} form under a {ran['mesh']} on every rank (graphs {ran['keys']}); "
        f"(K1, K2) over the run rank 0 {tuple(ran['launches'])} ({ran['samples']} samples), "
        + "".join(f"rank {r} {tuple(x['launches'])}, " for r, x in enumerate(ranks[1:], 1))
        + f"under replay {tuple(ran['replayed'])} a rank, the cadence's count; "
        + (f"resumed {tuple(again[0]['launches'])}, under replay "
           f"{tuple(again[0]['replayed'])}; " if resume else "not resumed; ")
        + f"graphs left after main {[x['left'] for x in ranks]}")
    ratio = "" if cli_s_per_it is None else (
        f"; single process (phase 10) {cli_s_per_it:.4f} s: ratio {per_it / cli_s_per_it:.4f}")
    log(f"[ddp_cli] torchrun --nproc_per_node {world}, tpu.distributed (NCCL), male2female "
        f"256^2 global batch {b} ({local} a rank) bf16: p50 D+G {p50['D+G']:.4f} s, D "
        f"{p50['D']:.4f} s ({counts} iterations), {per_it:.4f} s per iteration{ratio}; traced "
        f"(K1, K2) kernel events over iterations 11..15 {traced} (their steps launch "
        f"{window}); {DDP_ITERS} iterations {first_s:.1f} s ({first_s - timed:.1f} s of it "
        f"outside the iterations' timers: start-up and teardown)"
        + (f" and --resume to {DDP_RESUME_TO} {resume_s:.1f} s wall" if resume else "")
        + f"; files {ckpts}")
    return {"world": world, "traced": traced, "p50": p50, "per_it": per_it,
            "launches": [x["launches"] for x in ranks], "replayed": ran["replayed"],
            "first_s": first_s, "resume_s": resume_s}


def phase_devices(cfg, ckpt, outs16):
    """[devices] `Translator(devices=-1)` on the card equals phase 6's outputs;
    devices=2 raises the JAX message when one card is visible. Returns its
    (K1, K2) launches."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.serving import Translator

    imgs, styles = _requests()
    tr = Translator(cfg, ckpt, batch_size=BATCH, devices=-1)
    K.launches = K.bwd_launches = 0
    outs = tr(imgs, styles)
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    n_dev = torch.cuda.device_count()
    want = (LAUNCHES_PER_BATCH * -(-N_REQUESTS // BATCH) * n_dev, 0)  # each replica a batch
    if len(tr.replicas) != n_dev or launches != want:
        raise AssertionError(f"devices: {len(tr.replicas)} replicas on {n_dev} devices, "
                             f"(K1, K2) launches {launches}, expected {want}")
    if n_dev == 1 and not all(np.array_equal(a, b) for a, b in zip(outs, outs16)):
        raise AssertionError("devices: devices=-1 differs from phase 6's outputs")
    raised = "devices=2 not tried: more than one card is visible"
    if n_dev == 1:
        try:
            Translator(cfg, ckpt, batch_size=BATCH, devices=2)
        except ValueError as exc:
            raised = str(exc)
        if raised != "mesh_data=2 > available devices 1":
            raise AssertionError(f"devices: devices=2 gave {raised!r}")
    log(f"[devices] Translator(devices=-1): {len(tr.replicas)} replica(s) on {n_dev} "
        f"visible card(s), {N_REQUESTS} requests, (K1, K2) launches {launches}, outputs "
        f"equal to "
        f"phase 6's; devices=2 raised {raised!r}")
    return launches


def _vgg_loss_plain(vgg, img, target):
    """`models.vgg.compute_vgg_loss` with the plain instance norm."""
    from aclgan_tpu_torch.models.vgg import vgg_preprocess
    from aclgan_tpu_torch.ops.kernels.instance_norm import instance_norm_plain

    a = vgg(vgg_preprocess(img)).contiguous()
    b = vgg(vgg_preprocess(target)).contiguous()
    return torch.mean(torch.square((instance_norm_plain(a) - instance_norm_plain(b)).float()))


def phase_vgg():
    """[vgg] `compute_vgg_loss` at 256^2, batch 16, f32, TF32 off, both images
    needing a gradient: loss and image gradients with K1/K2 against the plain
    instance norm; ms per loss (forward and backward); (K1, K2) per loss."""
    from aclgan_tpu_torch.models.vgg import compute_vgg_loss, load_vgg16
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    vgg = load_vgg16(None, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    x, y = (torch.rand(VGG_BATCH, 3, VGG_SIZE, VGG_SIZE, device="cuda", generator=g) * 2 - 1
            for _ in range(2))

    def step(loss_fn):
        xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
        loss = loss_fn(vgg, xg, yg)
        loss.backward()
        return loss.detach(), xg.grad, yg.grad

    K.launches = K.bwd_launches = 0
    got = step(compute_vgg_loss)
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    if launches != (2, 2):
        raise AssertionError(f"vgg: (K1, K2) a loss {launches}, expected (2, 2)")
    want = step(_vgg_loss_plain)
    loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    grad_rel = [_rel(a, b) for a, b in zip(got[1:], want[1:])]
    if not math.isfinite(float(got[0])) or loss_rel > 1e-4 or max(grad_rel) > 1e-4:
        raise AssertionError(f"vgg: loss rel {loss_rel:.2e}, image gradients rel-L2 "
                             f"{grad_rel} (1e-4)")
    ms = {name: time_ms(lambda f=f: step(f), iters=5)
          for name, f in (("kernel", compute_vgg_loss), ("plain", _vgg_loss_plain))}
    peak = torch.cuda.max_memory_allocated()
    log(f"[vgg] compute_vgg_loss, Vgg16 to relu5_3, {VGG_BATCH}x3x{VGG_SIZE}^2 f32 (TF32 "
        f"off), both images needing a gradient: loss {float(got[0]):.6e}, vs plain: loss rel "
        f"{loss_rel:.2e}, image gradients rel-L2 {grad_rel[0]:.2e} / {grad_rel[1]:.2e}; "
        f"(K1, K2) a loss {launches} on ({VGG_BATCH * 512}, "
        f"{(VGG_SIZE // 8) ** 2}) rows; ms a loss (forward + backward, CUDA events, mean of "
        f"5): with K1/K2 {ms['kernel']:.3f}, plain {ms['plain']:.3f}; peak memory "
        f"{peak / 2**30:.3f} GiB")
    del vgg, x, y
    return launches


# ------------------------------------------------------------------ slice 8
SP_WORLD, SP_BATCH, SP_SIZE = 2, 2, 512  # [spatial_two_ranks]: 1 x 2 grid, global batch, H=W
SP_ROWS = SP_SIZE // SP_WORLD            # a rank's H
SPLIT_KERNELS = (  # counter, kernels-line name, the TPU kernel it replaces
    ("moments_launches", "instance_norm_row_moments", "aclgan_tpu/ops/pallas/instance_norm.py:67"),
    ("apply_launches", "instance_norm_apply", "aclgan_tpu/ops/pallas/instance_norm.py:67"),
    ("bwd_sums_launches", "instance_norm_bwd_row_sums",
     "aclgan_tpu/ops/pallas/instance_norm.py:102"),
    ("bwd_apply_launches", "instance_norm_bwd_apply",
     "aclgan_tpu/ops/pallas/instance_norm.py:102"))
COUNTERS = ("launches", "bwd_launches") + tuple(c for c, _, _ in SPLIT_KERNELS)
# a substring of each split kernel's name in a torch.profiler table
SPLIT_KERNEL_NAMES = {"instance_norm_row_moments": "row_moments_kernel",
                      "instance_norm_apply": "apply_kernel",
                      "instance_norm_bwd_row_sums": "bwd_row_sums_kernel",
                      "instance_norm_bwd_apply": "bwd_apply_kernel"}
# the split kernels' layouts off the main path: (label, shape, storage offset)
SPLIT_EDGE_CASES = (("a ragged 7 x 9 row", (2, 3, 7, 9), 0),
                    ("bases off 16 bytes (storage offset 1)", (2, 4, 16, 16), 1),
                    ("262,144-element rows", (1, 4, 512, 512), 0))


def _counts():
    """(K1, K2, K1m, K1a, K2m, K2a) launches since the last `_zero_counts`."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    return tuple(getattr(K, c) for c in COUNTERS)


def _zero_counts():
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    for c in COUNTERS:
        setattr(K, c, 0)


def _spatial_rank(rank, world, port, vcfg, x, style, xa, xb, z, out_dir):
    """One rank of [spatial_two_ranks], in its own process on the one card: a
    1 x world grid over gloo with CUDA tensors; this rank's H-slice of one
    `translate` and of one D+G `train_step` (the global z injected), then a
    second step timed warm. Saves outputs, metrics, params, (K1, K2, K1m, K1a,
    K2m, K2a), the all-reduces issued and peak memory of each."""
    import torch.distributed as dist

    from aclgan_tpu_torch.parallel.mesh import shard_state
    from aclgan_tpu_torch.parallel.spatial import make_mesh_2d, spatial_batch_sharding
    from aclgan_tpu_torch.trainer import ACLGAN
    from torch_ranks import group_timeout

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=group_timeout())
    all_reduce, calls = dist.all_reduce, [0]

    def counted(*args, **kwargs):  # every collective of the path is an all_reduce
        calls[0] += 1
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted
    try:
        mesh = make_mesh_2d(1, world)
        model = ACLGAN(vcfg, device="cuda", mesh=mesh)
        model.init_state()
        shard_state(model, mesh)
        rows, hs = spatial_batch_sharding(mesh, x.shape[0], x.shape[1])
        out = {}

        def start():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            calls[0] = 0
            return time.perf_counter()

        def done(t0, **rec):
            torch.cuda.synchronize()
            return dict(rec, s=time.perf_counter() - t0, launches=_counts(),
                        collectives=calls[0], peak=torch.cuda.max_memory_allocated())

        t0 = start()
        img, mask = model.translate(x[rows, hs], style[rows])
        out["translate"] = done(t0, img=img.cpu(), mask=mask.cpu())
        t0 = start()
        m = model.train_step(xa[rows, hs], xb[rows, hs], True, True, z=z)
        out["step"] = done(t0, metrics={k: float(v) for k, v in m.items()},
                           params=_params(model))
        t0 = start()
        model.train_step(xa[rows, hs], xb[rows, hs], True, True, z=z)
        out["warm"] = done(t0)
        torch.save(out, Path(out_dir) / f"spatial.{rank}.pt")
        del model
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()


def _stats_rel(what, got, want):
    """The largest relative difference of K1a's (mean, rsig) from `_stats`'s
    on the card; raises above 1e-6 (`rsqrtf` against `torch.rsqrt`, and
    torch's division by a scalar as a product with its reciprocal)."""
    rel = 0.0
    for a, b in zip(got, want):
        err = (a - b).abs()
        if not torch.all(err <= 1e-6 * b.abs()):
            raise AssertionError(f"instance_norm_apply {what}: mean / rsig off `_stats` by "
                                 f"{(err / b.abs()).max().item():.3g} relative (1e-6)")
        rel = max(rel, (err / b.abs().clamp_min(1e-30)).max().item())
    return rel


def _split_kernels(step_launches):
    """K1m, K1a, K2m, K2a against their plain versions on the card at a rank's
    shapes of phase 27 (f32 and bf16, IN and AdaIN, every fused activation,
    two launches of each bit-equal; K1a's mean and rsig against `_stats`),
    and on a ragged row, bases off 16 bytes and 262,144-element rows; each
    kernel's host microseconds a call against its library call's; the
    sharded forward's chain without the collective (K1m then K1a) and
    `_stats` alone; then each timed in bf16 over one D+G iteration's layers
    on a rank (K1m, K1a) or one G step's (K2m, K2a), by CUDA events and by
    torch.profiler's device time a launch; returns their kernels-line
    entries."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    g = torch.Generator(device="cuda").manual_seed(2)
    shapes = sorted({shape for shape, _, _ in _encode_mix(SP_BATCH, SP_ROWS, SP_SIZE)})
    max_err = {name: 0.0 for _, name, _ in SPLIT_KERNELS}
    stats_rel = 0.0
    for shape in shapes:
        n, c, h, w = shape
        base = torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.5
        dy_base = torch.randn(shape, device="cuda", generator=g)
        scale = torch.randn(n, c, device="cuda", generator=g)
        shift = torch.randn(n, c, device="cuda", generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy, tol = base.to(dtype), dy_base.to(dtype), TOL[dtype]
            for affine in (False, True):
                s, b = (scale, shift) if affine else (None, None)
                for activ in ("none", "relu", "lrelu", "tanh"):
                    moments = K.row_moments_plain(x)
                    y, mean, rsig = K.instance_norm_apply(x, moments, h * w, 1e-5, s, b, activ)
                    y2, mean2, rsig2 = K.instance_norm_apply(x, moments, h * w, 1e-5, s, b,
                                                             activ)
                    stats_rel = max(stats_rel, _stats_rel(f"{shape} {dtype}", (mean, rsig),
                                                          K._stats(moments, h * w, 1e-5)))
                    sums = K.bwd_row_sums_plain(x, y, dy, mean, rsig, activ)
                    n_all = h * w * SP_WORLD  # K2a divides by the rows' global length
                    checks = (
                        ("instance_norm_row_moments", K.instance_norm_row_moments(x),
                         moments, "rows"),
                        ("instance_norm_apply", y,
                         K.apply_plain(x, moments, h * w, 1e-5, s, b, activ)[0], "elements"),
                        ("instance_norm_bwd_row_sums",
                         K.instance_norm_bwd_row_sums(x, y, dy, mean, rsig, activ), sums,
                         "rows"),
                        ("instance_norm_bwd_apply",
                         K.instance_norm_bwd_apply(x, y, dy, mean, rsig, s, sums, n_all,
                                                   activ),
                         K.bwd_apply_plain(x, y, dy, mean, rsig, s, sums, n_all, activ),
                         "elements"))
                    again = (K.instance_norm_row_moments(x), y2,
                             K.instance_norm_bwd_row_sums(x, y, dy, mean, rsig, activ),
                             K.instance_norm_bwd_apply(x, y, dy, mean, rsig, s, sums, n_all,
                                                       activ))
                    torch.cuda.synchronize()
                    if not (torch.equal(mean, mean2) and torch.equal(rsig, rsig2)):
                        raise AssertionError(f"instance_norm_apply {shape} {dtype} "
                                             f"affine={affine} {activ}: two launches' "
                                             f"statistics differ")
                    for (name, got, _, _), got2 in zip(checks, again):
                        if not torch.equal(got, got2):
                            raise AssertionError(f"{name} {shape} {dtype} affine={affine} "
                                                 f"{activ}: two launches differ")
                    for name, got, want, kind in checks:
                        got, want = got.float(), want.float()
                        err = (got - want).abs()
                        max_err[name] = max(max_err[name], err.max().item())
                        # outputs elementwise as K1; the row sums against their largest
                        lim = tol + tol * want.abs() if kind == "elements" else \
                            tol * want.abs().max()
                        bad = (err > lim).sum().item()
                        if bad or not torch.isfinite(got).all():
                            raise AssertionError(
                                f"{name} {shape} {dtype} affine={affine} {activ}: {bad} "
                                f"values beyond tolerance, max err {err.max().item()}")
            del x, dy
        log(f"[kernel] split instance norm {shape}: K1m, K1a, K2m, K2a x 16 cases within "
            f"tolerance, two launches of each bit-equal")
        del base, dy_base
    stats_rel = max(stats_rel, _split_edge_checks(g, max_err))
    log("[kernel] split instance norm max abs err: "
        + ", ".join(f"{k} {v:.3g}" for k, v in max_err.items())
        + f"; K1a's mean / rsig against `_stats` max rel {stats_rel:.3g} (1e-6)")
    host = _split_host_cost()

    def make(shape, affine):
        n, c, h, w = shape
        x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        scale = torch.randn(n, c, device="cuda", generator=g) if affine else None
        shift = torch.randn(n, c, device="cuda", generator=g) if affine else None
        moments = K.row_moments_plain(x) * SP_WORLD  # the other rank's rows alike
        y, mean, rsig = K.instance_norm_apply(x, moments, h * w * SP_WORLD, 1e-5, scale, shift,
                                              "relu")
        dy = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        sums = K.bwd_row_sums_plain(x, y, dy, mean, rsig, "relu")
        # the library calls on the (1, N*C, H, W) view, given the statistics
        xv, dyv = x.view(1, n * c, h, w), dy.view(1, n * c, h, w)
        ones = torch.ones(n * c, device="cuda")
        lib = dict(xv=xv, dyv=dyv, mean=mean.flatten(), rsig=rsig.flatten(),
                   var=(rsig.flatten() ** -2 - 1e-5), ones=ones,
                   w=None if scale is None else scale.flatten(),
                   b=None if shift is None else shift.flatten())
        return x, y, dy, mean, rsig, scale, shift, sums, h * w * SP_WORLD, moments, lib

    def moments(x, *_):
        return K.instance_norm_row_moments(x)

    def apply(x, y, dy, mean, rsig, scale, shift, sums, n, moments, _):
        return K.instance_norm_apply(x, moments, n, 1e-5, scale, shift, "relu")

    def bwd_sums(x, y, dy, mean, rsig, *_):
        return K.instance_norm_bwd_row_sums(x, y, dy, mean, rsig, "relu")

    def bwd_apply(x, y, dy, mean, rsig, scale, shift, sums, n, *_):
        return K.instance_norm_bwd_apply(x, y, dy, mean, rsig, scale, sums, n, "relu")

    plain = {
        "instance_norm_row_moments": lambda x, *_: K.row_moments_plain(x),
        "instance_norm_apply": lambda x, y, dy, mean, rsig, scale, shift, sums, n, moments, _:
            K.apply_plain(x, moments, n, 1e-5, scale, shift, "relu"),
        "instance_norm_bwd_row_sums": lambda x, y, dy, mean, rsig, *_:
            K.bwd_row_sums_plain(x, y, dy, mean, rsig, "relu"),
        "instance_norm_bwd_apply": lambda x, y, dy, mean, rsig, scale, shift, sums, n, *_:
            K.bwd_apply_plain(x, y, dy, mean, rsig, scale, sums, n, "relu")}
    library = {  # one PyTorch call for the same function (no activation gate)
        "instance_norm_row_moments": (
            "torch.var_mean over H, W (correction 0)",
            lambda x, *a: torch.var_mean(x, dim=(2, 3), correction=0)),
        "instance_norm_apply": (
            "F.batch_norm in eval mode on the (1, N*C, H, W) view, the statistics as "
            "running stats (no activation; K1a also computes them from the moments and "
            "writes them)",
            lambda *a: F.batch_norm(a[-1]["xv"], a[-1]["mean"], a[-1]["var"], a[-1]["w"],
                                    a[-1]["b"], False, 0.0, 1e-5)),
        "instance_norm_bwd_row_sums": (
            "aten.native_batch_norm_backward for grad_weight and grad_bias only, given "
            "the statistics, no activation gate",
            lambda *a: torch.ops.aten.native_batch_norm_backward(
                a[-1]["dyv"], a[-1]["xv"], a[-1]["ones"], None, None, a[-1]["mean"],
                a[-1]["rsig"], True, 1e-5, [False, True, True])),
        "instance_norm_bwd_apply": (
            "aten.native_batch_norm_backward for grad_input only (it takes its row sums "
            "itself), given the statistics, no activation gate",
            lambda *a: torch.ops.aten.native_batch_norm_backward(
                a[-1]["dyv"], a[-1]["xv"], a[-1]["ones"], None, None, a[-1]["mean"],
                a[-1]["rsig"], True, 1e-5, [True, False, False]))}
    rows = lambda shape: shape[0] * shape[1]  # noqa: E731
    nbytes = {  # bf16 tensors read once, written once; f32 per-row vectors
        "instance_norm_row_moments": lambda shape, affine: 2 * math.prod(shape)
        + 8 * rows(shape),
        # x in, y out; the moments in, mean and rsig out, scale and shift in
        "instance_norm_apply": lambda shape, affine: 4 * math.prod(shape)
        + (24 if affine else 16) * rows(shape),
        "instance_norm_bwd_row_sums": lambda shape, affine: 6 * math.prod(shape)
        + 16 * rows(shape),
        "instance_norm_bwd_apply": lambda shape, affine: 8 * math.prod(shape)
        + (20 if affine else 16) * rows(shape)}
    flops = {"instance_norm_row_moments": 3.0, "instance_norm_apply": 5.0,
             "instance_norm_bwd_row_sums": 8.0, "instance_norm_bwd_apply": 10.0}
    runs = {"instance_norm_row_moments": moments, "instance_norm_apply": apply,
            "instance_norm_bwd_row_sums": bwd_sums, "instance_norm_bwd_apply": bwd_apply}
    _split_chain(make, moments, apply)
    mixes, tots, works = {}, {}, {}
    for counter, name, _ in SPLIT_KERNELS:  # CUDA events first, before any profiler session
        fwd = counter in ("moments_launches", "apply_launches")
        mixes[name] = (_d_step_mix(SP_BATCH, SP_ROWS, SP_SIZE) if fwd else []) + \
            _g_step_mix(SP_BATCH, SP_ROWS, SP_SIZE)
        works[name] = (f"one rank's {'D+G iteration' if fwd else 'G step'} of phase 27 "
                       f"(male2female {SP_SIZE}^2, batch {SP_BATCH}, 1 x {SP_WORLD} grid: "
                       f"{SP_ROWS} x {SP_SIZE} rows), timed in bf16")
        tots[name] = _time_mix(name, mixes[name], make, runs[name], plain[name],
                               library[name][1], nbytes[name], flops[name])
        _log_total(name, works[name], tots[name])
    entries = []
    for (counter, name, replaces), launches in zip(SPLIT_KERNELS, step_launches):
        mix, tot = mixes[name], tots[name]
        device, source = _device_us(mix, make, runs[name], library[name][1],
                                    SPLIT_KERNEL_NAMES[name])
        device_ms = library_device_ms = 0.0
        for (shape, affine, count), (dev_us, lib_us) in zip(mix, device):
            device_ms += count * dev_us / 1e3
            library_device_ms += count * lib_us / 1e3
            log(f"[kernel] {name} bf16 {shape} affine={affine} x{count}: device a launch "
                f"kernel {dev_us:.2f} us, library {lib_us:.2f} us, "
                f"{nbytes[name](shape, affine) / dev_us / 1e3:.0f} GB/s")
        log(f"[kernel] {name} device time per {works[name]} ({source}): kernel "
            f"{device_ms:.4f} ms (bound / device {100 * tot['bound_ms'] / device_ms:.1f}%), "
            f"library {library_device_ms:.4f} ms")
        entry = dict(
            name=name, route="cuda", source="aclgan_tpu_torch/csrc/instance_norm.cu",
            replaces=replaces, launches=launches, max_abs_err=max_err[name], ms=tot["ms"],
            plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"], bound_by=tot["bound_by"],
            library_ms=tot["library_ms"], library=library[name][0], work=works[name],
            device_ms=device_ms, library_device_ms=library_device_ms, device_source=source)
        if name in host:
            kernel_us, library_us = (sum(u) / len(u) for u in host[name])
            entry.update(host_us=kernel_us, library_host_us=library_us)
            n_launch = sum(count for _, _, count in mix)
            log(f"[kernel] {name} over the mix: {n_launch} launches x {kernel_us:.2f} us of "
                f"host a call = {n_launch * kernel_us / 1e3:.4f} ms host floor, device "
                f"{device_ms:.4f} ms, events {tot['ms']:.4f} ms; library {n_launch} x "
                f"{library_us:.2f} us = {n_launch * library_us / 1e3:.4f} ms, device "
                f"{library_device_ms:.4f} ms, events {tot['library_ms']:.4f} ms")
        entries.append(entry)
    return entries


def _split_edge_checks(g, max_err):
    """The split kernels against their plain versions where the plans leave
    the phase-27 shapes' 16-byte loads, clusters and chunks: a ragged row,
    bases off 16 bytes, 262,144-element rows; f32 and bf16, every activation
    for K1a, K2m and K2a, K1a and K2a for IN and AdaIN (from a bf16 strided
    slice), two launches of each bit-equal. Raises on a miss; folds the errors
    into `max_err`; returns the largest relative difference of K1a's mean and
    rsig from `_stats`."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    stats_rel = 0.0
    for label, shape, offset in SPLIT_EDGE_CASES:
        n, c, h, w = shape
        base = torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.5
        dy_base = torch.randn(shape, device="cuda", generator=g)
        packed = torch.randn(n, 3 * c, device="cuda", generator=g).to(torch.bfloat16)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = _at_offset(base.to(dtype), offset), _at_offset(dy_base.to(dtype), 2 * offset)
            tol = TOL[dtype]
            moments = K.row_moments_plain(x)
            mean, rsig = K._stats(moments, h * w, 1e-5)
            # (name, case, run, want, kind): "rows" sums against their largest,
            # "elements" outputs elementwise as K1
            cases = [("instance_norm_row_moments", "none",
                      lambda: K.instance_norm_row_moments(x), moments, "rows")]
            for activ in ("none", "relu", "lrelu", "tanh"):
                y = K.apply_plain(x, moments, h * w, 1e-5, None, None, activ)[0]
                cases.append(("instance_norm_bwd_row_sums", activ,
                              lambda a=activ, y=y: K.instance_norm_bwd_row_sums(x, y, dy, mean,
                                                                                rsig, a),
                              K.bwd_row_sums_plain(x, y, dy, mean, rsig, activ), "rows"))
                for s, b in ((None, None), (packed[:, c:2 * c], packed[:, :c])):
                    case = f"{activ} affine={s is not None}"
                    got = K.instance_norm_apply(x, moments, h * w, 1e-5, s, b, activ)
                    stats_rel = max(stats_rel, _stats_rel(f"{label} {dtype}", got[1:],
                                                          (mean, rsig)))
                    cases.append(("instance_norm_apply", case,
                                  lambda a=activ, s=s, b=b: torch.cat(
                                      [t.flatten().float() for t in K.instance_norm_apply(
                                          x, moments, h * w, 1e-5, s, b, a)]),
                                  K.apply_plain(x, moments, h * w, 1e-5, s, b, activ)[0],
                                  "elements"))
                    y_s = got[0]
                    sums = K.bwd_row_sums_plain(x, y_s, dy, mean, rsig, activ)
                    cases.append(("instance_norm_bwd_apply", case,
                                  lambda a=activ, s=s, y=y_s, sums=sums:
                                  K.instance_norm_bwd_apply(x, y, dy, mean, rsig, s, sums,
                                                            h * w, a),
                                  K.bwd_apply_plain(x, y_s, dy, mean, rsig, s, sums, h * w,
                                                    activ), "elements"))
            for name, case, run, want, kind in cases:
                got, again = run(), run()
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} {label} {dtype} {case}: two launches differ")
                if name == "instance_norm_apply":  # y, then mean and rsig (checked above)
                    got = got[:want.numel()].view(want.shape)
                got, want = got.float(), want.float()
                err = (got - want).abs()
                max_err[name] = max(max_err[name], err.max().item())
                lim = tol + tol * want.abs() if kind == "elements" else tol * want.abs().max()
                bad = (err > lim).sum().item()
                if bad or not torch.isfinite(got).all():
                    raise AssertionError(f"{name} {label} {shape} {dtype} {case}: {bad} "
                                         f"values beyond tolerance, max err {err.max().item()}")
        log(f"[kernel] split instance norm, {label} {shape}: K1m, K1a, K2m, K2a (every "
            f"activation; K1a, K2a IN and AdaIN) within tolerance in f32 and bf16, two "
            f"launches of each bit-equal")
        del base, dy_base
    return stats_rel


def _split_host_cost():
    """Host microseconds a call of each split kernel and of its library call
    (`torch.var_mean`; `native_batch_norm_backward`'s weight and bias
    gradients; eval-mode `F.batch_norm`, the statistics given;
    `native_batch_norm_backward`'s input gradient) at a shape whose kernels
    are trivial (1x1x8x8 bf16), in turns, 5000 calls each, as `_op_overhead`
    for K1. Returns {kernel name: (its us, the library call's us)}."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    x = torch.randn(1, 1, 8, 8, device="cuda").to(torch.bfloat16)
    y, dy = torch.relu(x), torch.randn_like(x)
    mean, rsig = torch.zeros(1, 1, device="cuda"), torch.ones(1, 1, device="cuda")
    moments = torch.stack([mean, rsig], -1) * 64
    ones, mean1, rsig1 = torch.ones(1, device="cuda"), mean.flatten(), rsig.flatten()
    calls = {
        "K1m": lambda: K.instance_norm_row_moments(x),
        "torch.var_mean": lambda: torch.var_mean(x, dim=(2, 3), correction=0),
        "K2m": lambda: K.instance_norm_bwd_row_sums(x, y, dy, mean, rsig, "relu"),
        "native_batch_norm_backward": lambda: torch.ops.aten.native_batch_norm_backward(
            dy, x, ones, None, None, mean1, rsig1, True, 1e-5, [False, True, True]),
        "K1a": lambda: K.instance_norm_apply(x, moments, 64, 1e-5, None, None, "relu"),
        "F.batch_norm": lambda: F.batch_norm(x, mean1, rsig1, None, None, False, 0.0, 1e-5),
        "K2a": lambda: K.instance_norm_bwd_apply(x, y, dy, mean, rsig, None, moments, 64,
                                                 "relu"),
        "native_batch_norm_backward dx": lambda: torch.ops.aten.native_batch_norm_backward(
            dy, x, ones, None, None, mean1, rsig1, True, 1e-5, [True, False, False])}
    us = {k: [] for k in calls}
    for turn in list(calls) + list(calls)[::-1]:
        for _ in range(200):
            calls[turn]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5000):
            calls[turn]()
        torch.cuda.synchronize()
        us[turn].append((time.perf_counter() - t0) / 5000 * 1e6)
    log("[kernel] split instance norm host cost a call (1x1x8x8 bf16, 5000 calls, in "
        "turns): " + "; ".join(f"{k} {', '.join(f'{u:.2f}' for u in v)} us"
                               for k, v in us.items()))
    return {"instance_norm_row_moments": (us["K1m"], us["torch.var_mean"]),
            "instance_norm_bwd_row_sums": (us["K2m"], us["native_batch_norm_backward"]),
            "instance_norm_apply": (us["K1a"], us["F.batch_norm"]),
            "instance_norm_bwd_apply": (us["K2a"], us["native_batch_norm_backward dx"])}


def _split_chain(make, moments, apply):
    """The sharded forward's chain without its collective, K1m then K1a
    (`_ShardedFusedInstanceNorm.forward` less the all-reduce), and `_stats`
    alone (the torch ops that ran between the all-reduce and K1a before K1a
    took the moments), each by CUDA events over one rank's D+G iteration of
    phase 27 in bf16; logs both."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    mix = _d_step_mix(SP_BATCH, SP_ROWS, SP_SIZE) + _g_step_mix(SP_BATCH, SP_ROWS, SP_SIZE)
    chain_ms = stats_ms = 0.0
    for shape, affine, count in mix:
        args = list(make(shape, affine))
        m, n = args[-2], args[-3]

        def chain():
            args[-2] = moments(args[0])
            return apply(*args)

        chain_ms += count * time_ms(chain)
        stats_ms += count * time_ms(lambda: K._stats(m, n, 1e-5))
        del args
    n_layers = sum(count for _, _, count in mix)
    log(f"[kernel] split forward chain without the all-reduce, K1m then K1a, over one rank's "
        f"D+G iteration of phase 27 ({n_layers} layers, bf16, CUDA events): {chain_ms:.4f} ms; "
        f"`_stats` alone (what K1a's fold removed): {stats_ms:.4f} ms")
    return chain_ms, stats_ms


def phase_spatial_two_ranks(cfg, tmp, smi):
    """[spatial_two_ranks] Two processes on the one card over gloo with CUDA
    tensors, a 1 x 2 (data, spatial) grid: male2female at full width, 512^2
    (the scale spatial sharding exists for), global batch 2, f32 with TF32
    off; one sharded translate and one D+G train_step against one process at
    512^2, batch 2; the split kernels against their plain versions and timed.
    Returns (the split kernels' entries, {path: launches} of each kernel)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    vcfg = _variant_cfg(cfg, SP_SIZE)
    b, size = SP_BATCH, SP_SIZE
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32))
    style = torch.from_numpy(rng.randn(b, vcfg.gen.style_dim).astype(np.float32))
    xa, xb = (torch.from_numpy(rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8))
              for _ in range(2))
    z = {k: [rng.randn(b, vcfg.gen.style_dim).astype(np.float32) for _ in range(3)]
         for k in ("dis", "gen")}
    out_dir = Path(tmp) / "spatial"
    out_dir.mkdir()
    torch.cuda.empty_cache()
    t0 = time.time()
    _spawn(_spatial_rank, SP_WORLD, (vcfg, x, style, xa, xb, z, str(out_dir)), 420, out_dir)
    ranks_s = time.time() - t0
    ranks = [torch.load(out_dir / f"spatial.{r}.pt", weights_only=True)
             for r in range(SP_WORLD)]

    model = _train_model(vcfg, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    img, mask = model.translate(x, style)
    torch.cuda.synchronize()
    single_translate_peak = torch.cuda.max_memory_allocated()
    gathered = [torch.cat([r["translate"][k] for r in ranks], 1) for k in ("img", "mask")]
    translate_diff = max(float((got - want.cpu()).abs().max())
                         for got, want in zip(gathered, (img, mask)))
    del img, mask
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = {k: float(v) for k, v in model.train_step(xa, xb, True, True, z=z).items()}
    single_s = time.perf_counter() - t0
    single_step_peak = torch.cuda.max_memory_allocated()
    want_params = _params(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train_step(xa, xb, True, True, z=z)
    torch.cuda.synchronize()
    single_warm_s = time.perf_counter() - t0
    del model
    gc_collect()

    if translate_diff > 1e-4:
        raise AssertionError(f"spatial translate: max |diff| {translate_diff:.3e} > 1e-4")
    r0, r1 = (r["step"] for r in ranks)
    worst = max(abs(r0["metrics"][k] - w) / max(abs(w), 1e-12) for k, w in want.items())
    if set(r0["metrics"]) != set(want) or worst > 1e-4 or r1["metrics"] != r0["metrics"]:
        raise AssertionError(f"spatial step: metrics max rel {worst:.2e} > 1e-4, or the ranks' "
                             f"metrics differ")
    param_err = {n: _rel(r0["params"][n], w) for n, w in want_params.items()}
    if max(param_err.values()) > 1e-3:
        raise AssertionError(f"spatial step: params rel-L2 {param_err} > 1e-3")
    if not all(torch.equal(r0["params"][n], r1["params"][n]) for n in r0["params"]):
        raise AssertionError("spatial step: the ranks' parameters differ")
    gib = 2.0 ** 30
    log(f"[spatial_two_ranks] male2female full width, {size}^2, global batch {b} on a 1 x "
        f"{SP_WORLD} (data, spatial) grid, {SP_ROWS} rows a rank, two processes on one card "
        f"({smi}; gloo, CUDA tensors), f32 TF32 off: translate max |diff| {translate_diff:.3e} "
        f"vs one process; one D+G iteration: metrics max rel {worst:.2e}, params rel-L2 max "
        f"{max(param_err.values()):.2e}, ranks equal; (K1, K2, K1m, K1a, K2m, K2a) each rank "
        f"translate {ranks[0]['translate']['launches']}, step {r0['launches']}")
    for r, rec in enumerate(ranks):
        log(f"[spatial_two_ranks] rank {r}: peak memory translate "
            f"{rec['translate']['peak'] / gib:.3f} GiB, D+G step {rec['step']['peak'] / gib:.3f}"
            f" GiB (one process: {single_translate_peak / gib:.3f}, "
            f"{single_step_peak / gib:.3f} GiB); all-reduces translate "
            f"{rec['translate']['collectives']}, D+G step {rec['step']['collectives']}; D+G "
            f"step {rec['step']['s']:.3f} s first, {rec['warm']['s']:.3f} s warm (both ranks "
            f"share the card)")
    log(f"[spatial_two_ranks] one process: D+G step {single_s:.3f} s first, "
        f"{single_warm_s:.3f} s warm; the rank processes took {ranks_s:.1f} s (start, build "
        f"load, translate, two steps)")
    # (K1, K2, K1m, K1a, K2m, K2a): every IN / AdaIN layer through the split form
    layers = {"translate": (0, 0, LAUNCHES_PER_BATCH, LAUNCHES_PER_BATCH, 0, 0),
              "step": (0, 0, 2 * K1_PER_STEP, 2 * K1_PER_STEP, K2_PER_G_STEP, K2_PER_G_STEP)}
    for r, rec in enumerate(ranks):
        for key, expect in layers.items():
            if rec[key]["launches"] != expect:
                raise AssertionError(f"spatial rank {r} {key}: (K1, K2, K1m, K1a, K2m, K2a) "
                                     f"{rec[key]['launches']}, expected {expect}")
    entries = _split_kernels(r0["launches"][2:])
    paths = {f"sharded translate, 1 x {SP_WORLD} grid at {size}^2, batch {b}, a rank (phase 27)":
             ranks[0]["translate"]["launches"],
             f"sharded train_step, one D+G iteration, 1 x {SP_WORLD} grid at {size}^2, batch "
             f"{b}, a rank (phase 27)": r0["launches"]}
    return entries, paths


# ------------------------------------------------------------------ graphs
# (do_dis, do_gen, step_increment) of phase 29's six training iterations; with
# step_size 4 the StepLR boundary falls at the fourth
GRAPH_SCHEDULE = [(True, True, 1), (True, False, 1), (True, True, 2), (True, False, 1),
                  (True, True, 1), (True, True, 1)]
# a D+G iteration's metrics taken before its D update changes a weight
PRE_UPDATE = ("loss_dis_", "loss_idt_", "loss_gen_focus_")
SERVE_BATCHES = (1, 8, 32)


def _graph_train_run(cfg, graphs, batches, reseed_at=None):
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    model = _train_model(cfg, "cuda", graphs=graphs)
    metrics, counts = [], []
    for i, ((xa, xb), (do_dis, do_gen, inc)) in enumerate(zip(batches, GRAPH_SCHEDULE)):
        if i == reseed_at:
            model.reseed_z(40)
        k = (K.launches, K.bwd_launches)
        metrics.append(model.train_step(xa, xb, do_dis, do_gen, inc))  # held across replays
        counts.append((K.launches - k[0], K.bwd_launches - k[1]))
    torch.cuda.synchronize()
    return model, [{k: float(v) for k, v in m.items()} for m in metrics], counts


def _train_state(model):
    """Every tensor a step updates (the five networks, the EMA, both
    optimizers' moments and counts), f64 on the host, and the z stream's
    next draw."""
    from aclgan_tpu_torch.trainer import DIS_NAMES, GEN_NAMES

    out = {}
    for n in GEN_NAMES:
        out.update({f"gen_{n}.{k}": v for k, v in model.gen(n).state_dict().items()})
        out.update({f"ema_{n}.{k}": v for k, v in (model.ema or {}).get(n, {}).items()})
    for n in DIS_NAMES:
        out.update({f"dis_{n}.{k}": v for k, v in model.dis(n).state_dict().items()})
    for key in ("gen_opt", "dis_opt"):
        opt = getattr(model, key)
        for i, p in enumerate(opt.param_groups[0]["params"]):
            out.update({f"{key}.{i}.{k}": v for k, v in opt.state[p].items()})
    out = {k: v.detach().double().cpu() for k, v in out.items()}
    z_next = torch.cat(model._draw_z(2)).cpu()
    return out, z_next


def _flat_rel(a, b):
    fa = torch.cat([v.flatten() for _, v in sorted(a.items())])
    fb = torch.cat([v.flatten() for _, v in sorted(b.items())])
    return float((fa - fb).norm() / fb.norm().clamp_min(1e-30))


ONE_STEP_COPIES = 3  # eager copies of the state that `one_step_spread` steps


def one_step_spread(cfg, model, batch):
    """One D+G iteration on `batch` from the graphed `model`'s state: replayed
    on `model`, and eager in `ONE_STEP_COPIES` copies of that state. Returns
    the metrics of each (the replay's first), their states after it
    (`_train_state`), the replayed state's rel-L2 from the first eager
    copy, and the rel-L2 of each pair of eager copies (the second's from
    the first first)."""
    import copy

    snap = model.snapshot()
    twins = []
    for _ in range(ONE_STEP_COPIES):
        twins.append(_train_model(cfg, "cuda", graphs=False))
        twins[-1].restore(copy.deepcopy(snap))  # no tensor shared with the source
    same = [{k: float(v) for k, v in m.train_step(*batch, True, True).items()}
            for m in (model, *twins)]
    after = [_train_state(m)[0] for m in (model, *twins)]
    del twins
    pairs = [_flat_rel(after[i], after[j]) for i in range(2, len(after)) for j in range(1, i)]
    return same, after, _flat_rel(after[0], after[1]), pairs


def graph_train_check(cfg, batches, reseed_at=None):
    """GRAPH_SCHEDULE on `batches` (one more than its iterations), eager three
    times and graphed (`reseed_z` before iteration `reseed_at` when given),
    then one D+G iteration on the last batch from the graphed model's state:
    replayed, and eager in three copies of that state (`one_step_spread`).
    Two eager runs differ from the first update on (atomic adds in the
    backward, e.g. the reflect pad's, sum in any order), and over six
    iterations that difference grows by amounts that vary several-fold from
    run to run, so the six-iteration spread is reported, not held to a
    ratio. Bars: the same launch counts; iteration 0's pre-update metrics
    bit-equal; every metric within the card-against-CPU bar (1e-3 relative +
    1e-6: a focus term can sit near 0) and each owner's state (a network,
    its EMA, an optimizer: a conv bias in front of a norm takes float-noise
    gradients, so single tensors can differ wholly) within its gradient bar
    rel-L2 1e-2; the z stream's next draw equal; and from one state, the
    metrics taken before the D update bit-equal in all four, and the
    replayed state's rel-L2 from the first eager copy no wider than two
    times the widest of the eager copies' pairwise rel-L2 (a spread read
    from three copies, not from one pair's single rounding draw; bit-equal
    where theirs is). Raises AssertionError naming what missed; returns
    what it measured (also the tests' check)."""
    runs = [_graph_train_run(cfg, g, batches, reseed_at) for g in (False, False, False, True)]
    (_, e1, c1), (_, e2, c2), _, (model, g, cg) = runs
    states = [_train_state(r[0]) for r in runs]
    same, after, step_graphed, pairs = one_step_spread(cfg, model, batches[-1])

    def worst(x, y):
        return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12) for k in y)

    (s1, z1), (s2, z2), (s3, _), (sg, zg) = states
    owners = sorted({k.split(".")[0] for k in s1})
    out = dict(
        counts=cg, keys=model.graphs.keys(),
        per_it=[(worst(gi, ei), worst(e2i, ei)) for gi, ei, e2i in zip(g, e1, e2)],
        first=[k for k in g[0] if k.startswith(PRE_UPDATE) and g[0][k] != e1[0][k]],
        by_owner={o: _flat_rel({k: v for k, v in sg.items() if k.split(".")[0] == o},
                               {k: v for k, v in s1.items() if k.split(".")[0] == o})
                  for o in owners},
        graphed=float(np.median([_flat_rel(sg, e) for e in (s1, s2, s3)])),
        widest=max(_flat_rel(s2, s1), _flat_rel(s3, s1), _flat_rel(s3, s2)),
        z_equal=torch.equal(zg, z1) and torch.equal(z2, z1), n_state=len(s1),
        pre=[k for k in same[0] if k.startswith(PRE_UPDATE)],
        step_graphed=step_graphed, step_eager=max(pairs),
        step_bit_equal={pair: sum(torch.equal(x[k], y[k]) for k in x) for pair, (x, y) in
                        {"replayed-eager": (after[0], after[1]),
                         "eager-eager": (after[2], after[1])}.items()})
    out["pre_bad"] = [k for k in out["pre"] if len({m[k] for m in same}) > 1]
    bad = [(i, k) for i, (gi, ei) in enumerate(zip(g, e1)) for k in ei
           if abs(gi[k] - ei[k]) > 1e-3 * abs(ei[k]) + 1e-6]
    bad_t = [o for o, r in out["by_owner"].items() if r > 1e-2]
    wider = (out["step_graphed"] > 2 * out["step_eager"] or out["step_graphed"] > 1e-2
             or (out["step_eager"] == 0) != (out["step_graphed"] == 0))
    if not c1 == c2 == cg:
        raise AssertionError(f"graphs: (K1, K2) a training iteration graphed {cg}, eager {c1}")
    if out["first"] or bad or bad_t or out["pre_bad"] or not out["z_equal"] or not out["pre"] \
            or wider:
        raise AssertionError(
            f"graphs: graphed training off eager: iteration 0 {out['first']}, metrics {bad}, "
            f"owners {bad_t}, pre-update {out['pre_bad']} of {len(out['pre'])}, z equal "
            f"{out['z_equal']}; from one state, state rel-L2 replayed-vs-eager "
            f"{out['step_graphed']:.3e} against the widest eager-vs-eager "
            f"{out['step_eager']:.3e}")
    del runs, model
    gc_collect()
    return out


def graph_cut(cfg):
    """Phase 29's training cut: phase 7's (f32, 128^2, batch 2, smooth focus
    terms) with EMA 0.999 and StepLR every 4, and GRAPH_SCHEDULE's batches
    and one more on the card. Returns (config, batches)."""
    size, b = 128, 2
    cfg = dataclasses.replace(
        cfg, focus_delta=0.0, focus_epsilon=10.0, step_size=4,
        tpu=dataclasses.replace(cfg.tpu, compute_dtype="float32", ema_decay=0.999),
        data=dataclasses.replace(cfg.data, crop_image_height=size, crop_image_width=size))
    rng = np.random.RandomState(29)
    batches = [tuple(torch.from_numpy(rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8))
                     .cuda() for _ in range(2)) for _ in range(len(GRAPH_SCHEDULE) + 1)]
    return cfg, batches


def _graph_train_equality(cfg):
    """`graph_train_check` at `graph_cut`. Returns the graphed run's (K1, K2)
    a training iteration."""
    cfg, batches = graph_cut(cfg)
    size, b = cfg.data.crop_image_height, batches[0][0].shape[0]
    r = graph_train_check(cfg, batches)
    log(f"[graphs] training f32 {size}^2 batch {b}, six iterations {GRAPH_SCHEDULE}: (K1, K2) "
        f"per iteration {r['counts']} in both forms; iteration 0's pre-update metrics "
        f"bit-equal; metrics max rel per iteration graphed-vs-eager / eager-vs-eager "
        + ", ".join(f"{a:.2e}/{c:.2e}" for a, c in r["per_it"])
        + f"; {r['n_state']} state tensors after six iterations: rel-L2 of all, graphed from "
        f"the three eager runs (median) {r['graphed']:.3e}, the widest eager pair "
        f"{r['widest']:.3e} (reported); graphed-vs-eager by owner "
        + ", ".join(f"{o} {x:.2e}" for o, x in r["by_owner"].items())
        + f"; z stream's next draw equal {r['z_equal']}; from one state, one D+G iteration: "
        f"its {len(r['pre'])} pre-update metrics bit-equal, state rel-L2 replayed-vs-eager "
        f"{r['step_graphed']:.3e} against the widest of {ONE_STEP_COPIES} eager copies' "
        f"pairs {r['step_eager']:.3e}, tensors "
        f"bit-equal {r['step_bit_equal']}. Not bit-equal after an update: two eager runs "
        f"differ there too (atomic adds in the backward, e.g. the reflect pad's, sum in any "
        f"order)")
    return r["counts"]


def _graph_translator_equality(cfg, ckpt):
    """Phase 5's requests in f32 through the eager Translator twice and a
    graphed one twice (the second pass all replays): uint8 outputs and masks
    bit-equal."""
    from aclgan_tpu_torch.serving import Translator

    cfg32 = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, compute_dtype="float32"))
    imgs, styles = _requests()
    outs = {}
    for name, graphs, passes in (("eager 1", False, 1), ("eager 2", False, 1),
                                 ("graphed", True, 2)):
        tr = Translator(cfg32, ckpt, batch_size=BATCH, graphs=graphs)
        for _ in range(passes):
            outs[name] = tr(imgs, styles, return_masks=True)
    keys = tr.model.graphs.keys()

    def equal(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))

    spread, same = equal(outs["eager 1"], outs["eager 2"]), equal(outs["graphed"], outs["eager 1"])
    log(f"[graphs] Translator f32, {N_REQUESTS} requests at batch {BATCH}: eager against "
        f"eager bit-equal {spread}, graphed (replays) against eager bit-equal {same}; "
        f"graphs {keys}")
    if not same:
        raise AssertionError("graphs: the graphed Translator's outputs differ from eager")
    del tr
    gc_collect()


SAMPLE_BATCH, SAMPLE_CALLS = 4, 3   # phase 29's `sample` check: display rows, calls a form


def _graph_sample_equality(cfg, train_pool):
    """`ACLGAN.sample` in f32 (TF32 off) at 256^2 on SAMPLE_CALLS display sets of
    one shape, eager and graphed (eager, captured, replayed): every output
    bit-equal, K1_PER_SAMPLE K1 launches a call in both forms. Logs the
    graph's capture bytes beside `train_pool`, the train step's; returns the
    graphed calls' (K1, K2)."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    cfg32 = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, compute_dtype="float32"))
    rng = np.random.RandomState(31)
    sets = [(torch.from_numpy(rng.randint(0, 256, (SAMPLE_BATCH, 256, 256, 3), dtype=np.uint8)),
             torch.from_numpy(rng.randint(0, 256, (SAMPLE_BATCH, 256, 256, 3), dtype=np.uint8)),
             *(torch.from_numpy(rng.randn(SAMPLE_BATCH, cfg.gen.style_dim).astype(np.float32))
               for _ in range(3))) for _ in range(SAMPLE_CALLS)]
    outs, counts, total, peak = {}, {}, {}, {}
    for form in ("eager", "graphed"):
        gc_collect()
        torch.cuda.reset_peak_memory_stats()
        model = _train_model(cfg32, "cuda", graphs=form == "graphed")
        outs[form], counts[form] = [], []
        for args in sets:
            k1, k2 = K.launches, K.bwd_launches
            outs[form].append([o.cpu() for o in model.sample(*args)])
            counts[form].append((K.launches - k1, K.bwd_launches - k2))
        total[form] = tuple(map(sum, zip(*counts[form])))
        peak[form] = torch.cuda.max_memory_allocated()
        if form == "graphed":
            keys = model.graphs.keys()
            capture = sum(model.graphs.capture_bytes.values())
        del model
        gc_collect()
    same = all(torch.equal(a, b) for ga, ea in zip(outs["graphed"], outs["eager"])
               for a, b in zip(ga, ea))
    if counts["graphed"] != counts["eager"] or any(c != (K1_PER_SAMPLE, 0)
                                                   for c in counts["graphed"]):
        raise AssertionError(f"graphs: sample (K1, K2) a call graphed {counts['graphed']}, "
                             f"eager {counts['eager']}, expected ({K1_PER_SAMPLE}, 0)")
    if not same or len(keys) != 1 or keys[0][0] != "sample":
        raise AssertionError(f"graphs: the graphed sample's outputs differ from eager "
                             f"(bit-equal {same}) or its graphs are {keys}")
    log(f"[graphs] sample f32 256^2, {SAMPLE_BATCH} display rows, {SAMPLE_CALLS} calls (eager, "
        f"captured, replayed): outputs bit-equal to eager; (K1, K2) a call {counts['graphed'][0]} "
        f"in both forms; the graph's capture {capture / 2**30:.3f} GiB ({capture} B) beside "
        f"the train step's pool at batch 3 {train_pool}; peak memory graphed "
        f"{peak['graphed'] / 2**30:.3f} GiB against eager {peak['eager'] / 2**30:.3f} (the "
        f"model's state included)")
    return total["graphed"]


def _step_flops(cfg):
    """FLOPs of the aten ops of one eager D+G and one D iteration at
    cfg.batch_size (convolutions forward and backward, matmuls; the
    instance-norm kernels are not aten ops and count none)."""
    from torch.utils.flop_counter import FlopCounterMode

    b = cfg.batch_size
    model = _train_model(cfg, "cuda", graphs=False)
    rng = np.random.RandomState(2)
    xa, xb = (torch.from_numpy(rng.randint(0, 256, (b, 256, 256, 3), dtype=np.uint8)).cuda()
              for _ in range(2))
    flops = {}
    for kind, do_gen in (("D+G", True), ("D", False)):
        counter = FlopCounterMode(display=False)
        with counter:
            model.train_step(xa, xb, True, do_gen)
        flops[kind] = counter.get_total_flops()
    del model
    gc_collect()
    return flops


def _serve_rate(cfg, ckpt, bs, graphs):
    """The bf16 Translator at batch bs on 256^2 requests: p50 ms a batch
    (CUDA events over 12 calls, resize and copies included) and img/s, the
    host's us to issue the served step alone (p50 of 20, each after a
    synchronize), peak memory, the graph's pool and capture seconds."""
    from aclgan_tpu_torch.serving import Translator

    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    tr = Translator(cfg, ckpt, batch_size=bs, graphs=graphs)
    imgs, styles = _requests()
    batch = (imgs[:bs], styles[:bs])
    for _ in range(2):
        tr(*batch)
    ms = []
    for _ in range(12):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tr(*batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    x = torch.randint(0, 256, (bs, 256, 256, 3), dtype=torch.uint8, device="cuda")
    z = torch.randn(bs, cfg.gen.style_dim, device="cuda")
    host = []
    with torch.inference_mode():
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr._served(tr.model, x, z)
            host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    p50 = float(np.median(ms))
    out = dict(ms=p50, img_s=bs / p50 * 1e3, host_us=float(np.median(host)) * 1e6,
               peak=torch.cuda.max_memory_allocated(), pool=_pool(tr.model),
               capture_s=[round(v, 4) for v in (tr.model.graphs.capture_seconds.values()
                                                if graphs else ())])
    del tr
    return out


def phase_graphs(cfg, ckpt, smi, cli_b3_s):
    """[graphs] The CUDA graphs against the eager forms: equality (Translator
    and training, f32), the bare bf16 step at batch 3 and 16 and the
    Translator at batch 1, 8 and 32 in both forms, in turns. Returns
    {path: (K1, K2)} of the graphed runs."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[graphs] {smi}")
    _graph_translator_equality(cfg, ckpt)
    paths = {"graphs: six f32 training iterations at 128^2, batch 2, graphed (phase 29)":
             tuple(map(sum, zip(*_graph_train_equality(cfg))))}
    flops = _step_flops(dataclasses.replace(cfg, batch_size=TRAIN_BATCH))
    for b, windows, window in ((cfg.batch_size, 5, 8), (TRAIN_BATCH, 3, 6)):
        derived = dataclasses.replace(cfg, batch_size=b)
        res = {form: _bare_train_step(derived, form == "graphed", windows, window)
               for form in ("graphed", "eager")}
        if b == cfg.batch_size:
            paths[f"graphs: sample at 256^2, {SAMPLE_BATCH} rows, {SAMPLE_CALLS} calls, "
                  "graphed (phase 29)"] = _graph_sample_equality(cfg, res["graphed"]["pool"])
        paths[f"graphs: bare train_step at batch {b}, D1/G2, {sum(res['graphed']['iterations'].values())} "
              "iterations, graphed (phase 29)"] = res["graphed"]["launches"]
        tflops = ""
        if b == TRAIN_BATCH:
            per_pair = flops["D+G"] + flops["D"]
            tflops = "; TFLOP/s of aten ops at D1/G2 " + ", ".join(
                f"{f} {per_pair / (2 * r['s']) / 1e12:.1f}" for f, r in res.items())
        g, e = res["graphed"], res["eager"]
        log(f"[graphs] {smi}: bare bf16 step 256^2 batch {b}, D1/G2: graphed {g['s']:.4f} s "
            f"an iteration against eager {e['s']:.4f} s (ratio {g['s'] / e['s']:.4f}); host "
            f"{g['host_s']:.4f} s against {e['host_s']:.4f} s to issue one; device idle "
            f"{100 * g['idle']:.1f}% against {100 * e['idle']:.1f}%; peak memory "
            f"{g['peak'] / 2**30:.3f} against {e['peak'] / 2**30:.3f} GiB, graphs' pool "
            f"{g['pool']}; capture s {g['capture_s']}{tflops}")
    log(f"[graphs] {smi}: FLOPs of one eager iteration at batch {TRAIN_BATCH}: D+G "
        f"{flops['D+G'] / 1e12:.3f} TFLOP, D {flops['D'] / 1e12:.3f} TFLOP; the train CLI "
        f"at batch {cfg.batch_size}, graphed (phase 9): {cli_b3_s:.4f} s an iteration")
    for bs in SERVE_BATCHES:
        res = {form: _serve_rate(cfg, ckpt, bs, form == "graphed") for form in ("graphed", "eager")}
        g, e = res["graphed"], res["eager"]
        log(f"[graphs] {smi}: Translator bf16 256^2 batch {bs}: graphed {g['img_s']:.1f} img/s, "
            f"p50 {g['ms']:.3f} ms a batch, against eager {e['img_s']:.1f} img/s, "
            f"{e['ms']:.3f} ms (ratio {e['ms'] / g['ms']:.4f}); host {g['host_us']:.1f} us a "
            f"replay against {e['host_us']:.1f} us eager; capture s {g['capture_s']}; "
            f"graph's pool {g['pool']}; peak memory {g['peak'] / 2**30:.3f} against "
            f"{e['peak'] / 2**30:.3f} GiB")
    gc_collect()
    return paths


# ------------------------------------------------------------------ meshes
MESH_BATCHES = (3, TRAIN_BATCH)      # the world-1 bare step's batches (phase 29's; 16 on 2+ cards)
MESH_WORLDS = (2, 4)                 # the 2-4 card part's data-parallel worlds
MESH_DEADLINE = 420                  # s: one spawn of phase 30, every rank dumped and killed after
MESH_GRAPHS = "--mesh-graphs"        # chip_smoke.py's own argument: phase 30 alone


def _mesh_rank(rank, world, port, jobs, out_dir):
    """One NCCL rank of [mesh_graphs], on card `rank`, TF32 off: runs each job
    of `jobs` (name, args of `_job_bare`) and saves their results to
    out_dir/mesh.<rank>.pt. Ranks other than 0 print nothing."""
    import torch.distributed as dist

    from torch_ranks import group_timeout, teardown

    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if rank:
        sys.stdout = open(os.devnull, "w")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=group_timeout())
    try:
        out = {name: _job_bare(*args) for name, args in jobs}
        torch.save(out, Path(out_dir) / f"mesh.{rank}.pt")
    finally:
        teardown()  # `_bare_train_step` destroys each model's graphs


def _job_bare(cfg, b, graphs, n_spatial=1):
    """The bare step at b rows a rank under a `DataMesh`, or at a global batch
    of b on a 1 x n_spatial grid of every rank (`_bare_train_step`; `graphs`
    as the trainer takes it)."""
    from aclgan_tpu_torch.parallel.mesh import make_mesh
    from aclgan_tpu_torch.parallel.spatial import make_mesh_2d

    mesh = make_mesh(-1) if n_spatial == 1 else make_mesh_2d(1, n_spatial)
    return _bare_train_step(dataclasses.replace(cfg, batch_size=b), graphs, 3, 6, mesh=mesh)


def _spatial_cut(cfg):
    """Phase 27's cut of the spatial step: full width, f32, 512^2."""
    return _variant_cfg(cfg, SP_SIZE)


def _mesh_spawn(world, jobs, tmp, tag):
    """Runs `jobs` on `world` NCCL ranks, one a card, under one deadline;
    returns each rank's results and the seconds the processes took."""
    out_dir = Path(tmp) / f"mesh_{tag}"
    out_dir.mkdir()
    t0 = time.time()
    _spawn(_mesh_rank, world, (jobs, str(out_dir)), MESH_DEADLINE, out_dir)
    return ([torch.load(out_dir / f"mesh.{r}.pt", map_location="cpu", weights_only=False)
             for r in range(world)], time.time() - t0)


def _log_bare(smi, what, g, e, step="bare bf16 step 256^2"):
    log(f"[mesh_graphs] {smi}: {what}, {step}, D1/G2: graphed {g['s']:.4f} s an "
        f"iteration against eager {e['s']:.4f} s (ratio {g['s'] / e['s']:.4f}); host "
        f"{g['host_s']:.4f} against {e['host_s']:.4f} s to issue one; device idle "
        f"{100 * g['idle']:.1f}% against {100 * e['idle']:.1f}%; peak {g['peak'] / 2**30:.3f} "
        f"against {e['peak'] / 2**30:.3f} GiB; graphs' pool {g['pool']}, capture s "
        f"{g['capture_s']}; launches {g['launches']} over {g['iterations']} = the cadence's "
        f"count")


MESH_CASES = (("dp_dis_in", 2, 1, "in"), ("dp_dis_bn", 2, 1, "bn"))  # name, grid, dis norm
# The replayed third iteration against one process: the metrics that do not
# read the D this iteration moved (rel) and each network after it (rel-L2).
# The bars were set while the one-process run started from a state whose
# optimizer moments an eager twin had already stepped (1.13e-3 params); from
# the state itself two NCCL ranks on H100s read 1.2e-5 to 3.0e-5 (DP pair and
# grids). The G step's adversarial losses read the D this iteration moved,
# through its norms, and are logged only.
MESH_ALONE_BARS = (1e-4, 3e-3)
MESH_AFTER_D_STEP = ("loss_gen_adv_", "loss_gen_total")  # metrics that read the moved D
# the graphed spatial grids of the 2-4 card part, each in its own spawn
GRID_CASES = (("spatial_1x2", 1, 2, "bn"), ("spatial_2x2", 2, 2, "bn"))


def _mesh_cases(cfg, tmp, device_type="cuda", specs=MESH_CASES, deadline=MESH_DEADLINE,
                rank_opts=(True, True), tag="mesh_cases"):
    """The 2-card correctness part of phase 30, in one pair of NCCL ranks
    (`torch_ranks.mesh_graph_steps`): the data-parallel D+G step for dis in
    and then dis bn (the first case's graphs destroyed and its models
    dropped before the second is built), each at phase 23's cut (f32, TF32
    off, 128^2, two rows a data index) from one state, replayed and in an
    eager twin. The replay is held to its twin and to one process on the
    first card: to its twin at phase 23's bars (metrics rel 1e-4, each
    network's rel-L2 1e-3), to one process at `MESH_ALONE_BARS` (the G
    step's adversarial metrics, which read the D the iteration moved,
    logged), the ranks to each other bit for bit. Returns {case: (K1, K2,
    K1m, K1a, K2m, K2a) of a replayed iteration on rank 0}. `specs` may
    name spatial grids (n_data, n_spatial), all of one size, which the
    spawn's ranks form; `rank_opts` are `mesh_graph_steps`' (release,
    halo_p2p, explicit_teardown, eager_copies), which
    `tools/torch_mesh_graphs.py` sets to reproduce what the trainer or the
    harness does not do. With eager_copies > 1 the replayed state is also
    held within 2x the widest pair of the eager copies (phase 29's rule).
    With `device_type` "cpu", gloo ranks and the tests' stand-in graph (a
    rehearsal of the checks). `tag` names its directory under `tmp`."""
    from aclgan_tpu_torch.trainer import ACLGAN
    from torch_ranks import mesh_graph_steps

    size = 128
    world = {n_data * n_spatial for _, n_data, n_spatial, _ in specs}.pop()
    cases, inputs = [], {}
    out_dir = Path(tmp) / tag
    out_dir.mkdir()
    for name, n_data, n_spatial, norm in specs:
        vcfg = _variant_cfg(cfg, size, dis=dict(norm=norm))
        b = 2 * n_data
        rng = np.random.RandomState(8)
        xa, xb = (torch.from_numpy(rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8))
                  for _ in range(2))
        zs = [{k: [rng.randn(b, vcfg.gen.style_dim).astype(np.float32) for _ in range(3)]
               for k in ("dis", "gen")} for _ in range(3)]
        start = ACLGAN(vcfg, device=device_type, seed=1)
        start.init_state()
        snap = out_dir / f"start.{name}.pt"
        torch.save(start.snapshot(), snap)
        del start
        cases.append((name, n_data, n_spatial, vcfg.to_dict(), str(snap), xa, xb, zs))
        inputs[name] = (vcfg, xa, xb, zs[2])
    gc_collect()
    t0 = time.time()
    _spawn(mesh_graph_steps, world, (cases, str(out_dir), device_type, *rank_opts), deadline,
           out_dir)
    secs = time.time() - t0
    counts = {}
    for name, n_data, n_spatial, _ in specs:
        vcfg, xa, xb, z = inputs[name]
        ranks = [torch.load(out_dir / f"mesh.{name}.{r}.pt", map_location="cpu",
                            weights_only=False) for r in range(world)]
        single = _train_model(vcfg, device_type, graphs=False)
        single.restore(ranks[0]["state"])
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        m = {k: float(v) for k, v in single.train_step(xa, xb, True, True, z=z).items()}
        one = {"metrics": m, **{kind: {n: {k: v.cpu() for k, v in sd.items()}
                                       for n, sd in single.snapshot()[kind].items()}
                                for kind in ("gen", "dis")}}
        del single
        shape = (2, size // n_spatial, size, 3)  # a rank's rows and H-slice
        key = ("train", True, True, shape, torch.uint8, shape, torch.uint8, False)
        twin, alone = [], []
        for r in ranks:
            g = r["graphed"]
            if r["keys"] != [key]:
                raise AssertionError(f"mesh_graphs {name}: graphs' keys {r['keys']}, not "
                                     f"[{key}]")
            if g["launches"] != r["eager"]["launches"]:
                raise AssertionError(f"mesh_graphs {name}: replayed launches {g['launches']}, "
                                     f"eager {r['eager']['launches']}")
            twin.append(_mesh_gap(g, r["eager"]))
            if twin[-1][0] > 1e-4 or twin[-1][2] > 1e-3:
                raise AssertionError(f"mesh_graphs {name}: replayed against its eager twin: "
                                     f"metrics rel {twin[-1][0]:.2e} ({twin[-1][1]}; bar 1e-4), "
                                     f"params rel-L2 {twin[-1][2]:.2e} (bar 1e-3)")
            if "eager_pairs" in r and r["graphed_rel"] > 2 * max(r["eager_pairs"]):
                raise AssertionError(f"mesh_graphs {name}: the replayed state's rel-L2 from the "
                                     f"first eager copy {r['graphed_rel']:.3e}, over 2x the "
                                     f"widest pair of eager copies {r['eager_pairs']}")
            alone.append(_mesh_gap(g, one, MESH_AFTER_D_STEP))
            moved = max((abs(g["metrics"][k] - w) / max(abs(w), 1e-12), k)
                        for k, w in one["metrics"].items() if k.startswith(MESH_AFTER_D_STEP))
            if alone[-1][0] > MESH_ALONE_BARS[0] or alone[-1][2] > MESH_ALONE_BARS[1]:
                raise AssertionError(f"mesh_graphs {name}: replayed against one process: "
                                     f"metrics rel {alone[-1][0]:.2e} ({alone[-1][1]}; bar "
                                     f"{MESH_ALONE_BARS[0]}), params rel-L2 {alone[-1][2]:.2e} "
                                     f"(bar {MESH_ALONE_BARS[1]})")
            for kind in ("gen", "dis"):
                for n, sd in g[kind].items():
                    if not all(torch.equal(t, ranks[0]["graphed"][kind][n][k])
                               for k, t in sd.items()):
                        raise AssertionError(f"mesh_graphs {name}: the ranks' {kind} {n} differ")
        counts[name] = ranks[0]["graphed"]["launches"]
        tw, al = max(twin), max(alone)
        log(f"[mesh_graphs] {name} ({n_data} x {n_spatial} NCCL ranks, male2female full width, "
            f"{size}^2, f32, global batch {2 * n_data}): the replayed D+G iteration against its "
            f"eager twin: metrics rel {tw[0]:.2e} ({tw[1]}), params rel-L2 {tw[2]:.2e} (bars "
            f"1e-4, 1e-3); against one process: the metrics that do not read the moved D "
            f"{al[0]:.2e} ({al[1]}), params {al[2]:.2e} (bars {MESH_ALONE_BARS[0]}, "
            f"{MESH_ALONE_BARS[1]}), the G step's adversarial metrics (logged) "
            f"{moved[0]:.2e} ({moved[1]}); ranks equal; (K1, K2, K1m, K1a, K2m, K2a) a replay "
            f"{counts[name]} = eager; capture bytes "
            f"{list(ranks[0]['capture_bytes'].values())}"
            + ("" if "eager_pairs" not in ranks[0] else
               "; the replayed state's rel-L2 from the first eager copy, beside each pair of "
               "eager copies (phase 29's rule: at most 2x the widest), rank by rank: "
               + "; ".join(f"{r['graphed_rel']:.3e} against "
                           f"{', '.join(f'{x:.3e}' for x in r['eager_pairs'])}"
                           for r in ranks)))
    log(f"[mesh_graphs] the {len(specs)} cases in one pair of rank processes took {secs:.1f} s")
    return counts


def _mesh_gap(got, want, skip=()):
    """(metrics max rel, that metric, networks max rel-L2) of one rank's step
    against another's, the metrics whose names start with one of `skip`
    left out."""
    name, met = max(((k, abs(got["metrics"][k] - w) / max(abs(w), 1e-12))
                     for k, w in want["metrics"].items() if not k.startswith(tuple(skip))),
                    key=lambda kv: kv[1])
    par = 0.0
    for kind in ("gen", "dis"):
        for n, sd in want[kind].items():
            ref = torch.cat([v.double().flatten() for v in sd.values()])
            mine = torch.cat([v.double().flatten() for v in got[kind][n].values()])
            par = max(par, float((mine - ref).norm() / ref.norm().clamp_min(1e-30)))
    return met, name, par


def phase_mesh_graphs(cfg, tmp, smi, cli_s_per_it=None, worlds=MESH_WORLDS, cli_runs=1,
                      pair=True):
    """[mesh_graphs] The train step under an NCCL mesh replayed as a CUDA
    graph with its collectives inside, against the eager form: a
    `DataMesh` of one rank (a spawned process), the bare bf16 step at batch
    3 (and, where the 2-4 card part runs, its references: 16, and the f32
    step at 512^2, global batch 2). On two or more cards, the 2-4 card part:
    the 2-card data-parallel correctness cases (`_mesh_cases`; left out with
    `pair` False), the graphed spatial grids of `GRID_CASES` that the host
    has the cards for, each in its own spawn, held to their eager twins at
    phase 23's bars and phase 29's rule, then at each world of `worlds` the
    host has: the bare step at global batch 16 (16 / world rows a rank, one
    rank a card) and the spatial step at 512^2 on a 1 x world grid, each in
    both forms against one card, and the train CLI under torchrun
    (`phase_ddp_cli`) `cli_runs` times in a row, the first resumed to 35.
    Returns {path: launches}."""
    n_cards = torch.cuda.device_count()
    log(f"[mesh_graphs] {smi}; {n_cards} card(s)")
    paths = {}
    more = n_cards >= 2  # the references of the 2-4 card part run only with it
    jobs = [(f"b{b} {f}", (cfg, b, f == "graphed"))
            for b in (MESH_BATCHES if more else MESH_BATCHES[:1]) for f in ("graphed", "eager")]
    if more:
        jobs += [(f"sp {f}", (_spatial_cut(cfg), SP_BATCH, f == "graphed"))
                 for f in ("graphed", "eager")]
    one, secs = _mesh_spawn(1, jobs, tmp, "w1")
    res = one[0]
    for b in (MESH_BATCHES if more else MESH_BATCHES[:1]):
        _log_bare(smi, f"DataMesh of 1 rank (NCCL), batch {b}", res[f"b{b} graphed"],
                  res[f"b{b} eager"])
        paths[f"DataMesh of 1 rank (NCCL), bare train_step at batch {b}, graphed "
              f"(phase 30)"] = res[f"b{b} graphed"]["launches"]
    if more:
        _log_bare(smi, f"one process (a DataMesh of 1 rank), batch {SP_BATCH}", res["sp graphed"],
                  res["sp eager"], f"f32 step {SP_SIZE}^2")
    log(f"[mesh_graphs] the world-1 process took {secs:.1f} s")
    if not more:
        log(f"[mesh_graphs] the 2-4 card part (graphed steps and the train CLI across ranks) "
            f"needs two or more cards; {n_cards} visible: not run here")
        return paths
    for name, c in (_mesh_cases(cfg, tmp) if pair else {}).items():
        paths[f"2 NCCL ranks, {name}, a replayed D+G iteration at 128^2, f32 "
              f"(phase 30)"] = c
    for grid in GRID_CASES:
        name, n_data, n_spatial, _ = grid
        if n_data * n_spatial > n_cards:
            log(f"[mesh_graphs] {name} needs {n_data * n_spatial} cards; {n_cards} visible: "
                f"not run")
            continue
        for _, c in _mesh_cases(cfg, tmp, specs=(grid,), tag=name,
                                rank_opts=(True, True, False, ONE_STEP_COPIES)).items():
            paths[f"{n_data} x {n_spatial} NCCL grid, a replayed D+G iteration at 128^2, f32, "
                  f"a rank (phase 30)"] = c
    one, sp_one = res[f"b{TRAIN_BATCH} graphed"], res["sp graphed"]
    for world in worlds:
        if world > n_cards:
            log(f"[mesh_graphs] world {world} needs {world} cards; {n_cards} visible: not run")
            continue
        b = TRAIN_BATCH // world
        ranks, secs = _mesh_spawn(world, [(f, (cfg, b, f == "graphed"))
                                          for f in ("graphed", "eager")]
                                  + [(f"sp {f}", (_spatial_cut(cfg), SP_BATCH, f == "graphed",
                                                  world)) for f in ("graphed", "eager")],
                                  tmp, f"w{world}")
        g, e = ranks[0]["graphed"], ranks[0]["eager"]
        _log_bare(smi, f"DataMesh of {world} ranks (NCCL), {b} rows a rank (global "
                       f"{TRAIN_BATCH})", g, e)
        log(f"[mesh_graphs] {smi}: world {world} against one card at batch {TRAIN_BATCH} "
            f"graphed {one['s']:.4f} s: graphed {one['s'] / g['s']:.3f}x, eager "
            f"{one['s'] / e['s']:.3f}x the iteration rate; the world-{world} processes took "
            f"{secs:.1f} s")
        sg, se = ranks[0]["sp graphed"], ranks[0]["sp eager"]
        _log_bare(smi, f"1 x {world} spatial grid (NCCL), global batch {SP_BATCH}", sg, se,
                  f"f32 step {SP_SIZE}^2")
        log(f"[mesh_graphs] {smi}: the 1 x {world} grid against one process at {SP_SIZE}^2, "
            f"batch {SP_BATCH}, graphed {sp_one['s']:.4f} s: graphed "
            f"{sp_one['s'] / sg['s']:.3f}x, eager {sp_one['s'] / se['s']:.3f}x the step rate; "
            f"peak a rank {sg['peak'] / 2**30:.3f} GiB against {sp_one['peak'] / 2**30:.3f}, "
            f"pool {sg['pool']} against {sp_one['pool']}; split kernels a traced D+G + D "
            f"(device ms, events): graphed {sg['split_ms']}, eager {se['split_ms']}")
        for r, got in enumerate(ranks):
            mine, first = ([x[f]["launches"] for f in ("graphed", "eager", "sp graphed")]
                           for x in (got, ranks[0]))
            if mine != first:
                raise AssertionError(f"mesh_graphs world {world}: rank {r} launched {mine} "
                                     f"(graphed, eager, spatial graphed), rank 0 {first}")
        paths[f"DataMesh of {world} ranks (NCCL), bare train_step at {b} rows a rank, "
              f"graphed, a rank (phase 30)"] = g["launches"]
        paths[f"1 x {world} NCCL grid, bare train_step at {SP_SIZE}^2, global batch "
              f"{SP_BATCH}, graphed, a rank (phase 30)"] = sg["launches"]
        for i in range(cli_runs):
            t0 = time.time()
            got = phase_ddp_cli(cfg, tmp, cli_s_per_it, world, resume=i == 0)
            log(f"[mesh_graphs] the train CLI at world {world}, run {i + 1} of {cli_runs}: "
                f"ended in {time.time() - t0:.1f} s")
        if cli_runs:
            paths[f"torchrun train CLI at world {world}, batch {TRAIN_BATCH}: kernel events "
                  f"over the traced iterations 11..15 (phase 30)"] = got["traced"]
    return paths


def mesh_graphs_alone(argv) -> int:
    """`python3 chip_smoke.py --mesh-graphs [--worlds 2,4] [--cli-runs N]
    [--no-pair]`: the kernels' build and phase 30 alone (on 2-4 cards, its
    multi-rank part at the worlds given that the host has, the train CLI N
    times in a row at each, the correctness pair left out with
    `--no-pair`), for a call that needs only it; prints its paths' launches
    as one JSON line."""
    import argparse

    ap = argparse.ArgumentParser(prog=f"chip_smoke.py {MESH_GRAPHS}")
    ap.add_argument("--worlds", default=",".join(map(str, MESH_WORLDS)))
    ap.add_argument("--cli-runs", type=int, default=1)
    ap.add_argument("--no-pair", dest="pair", action="store_false")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    sys.path.insert(0, str(ROOT))
    from aclgan_tpu_torch.config import load_config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.time()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        paths = phase_mesh_graphs(load_config(CONFIG), tmp, smi,
                                  worlds=tuple(int(w) for w in args.worlds.split(",")),
                                  cli_runs=args.cli_runs, pair=args.pair)
    print(json.dumps({"mesh_graphs": paths}), flush=True)
    log(f"[done] {time.time() - t0:.1f} s")
    return 0


# ------------------------------------------------------------------ acceptance
ACC_ITERS = (20, 40)                # the mini run's two calls: fresh, then --resume


def _acceptance_tool():
    """`tools/torch_synthfaces_hard.py` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_synthfaces_hard", ROOT / "tools" / "torch_synthfaces_hard.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


MOVE_TOL_GEN = 0.05   # tests/torch_parity.py: a generator's movement across frameworks


def _ema_card_vs_cpu(cfg, decay):
    """One f32 D+G iteration then one D iteration with EMA `decay`, at phase
    7's cut, on the card against the CPU. Adam's first step moves each
    weight by about lr, so the EMA moves by about (1 - d) * lr: at lr 1e-4
    that is 1e-7, the size of the EMA's own float32 rounding. So the EMA
    after the G step is held to d * EMA + (1 - d) * the stepped weights in
    the trainer's float32 arithmetic on the card, within 1e-2 of
    (1 - d) * max |stepped - initial weights|, and the same form with the
    weights from before the step must miss it by at least half of that (the
    check separates the two orders). The D iteration leaves the EMA as it
    was. The EMA's movement is within the parity tests' movement bar
    (rel-L2 0.05) of the CPU's; the weights whose gradient is float noise
    move by +-lr with another sign on the two devices, so the live weights'
    movement and the share of steps of another sign are logged beside it.
    Returns the figures."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.trainer import GEN_NAMES

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    size, b = 128, 2
    vcfg = _variant_cfg(cfg, size, ema_decay=decay)
    rng = np.random.RandomState(11)
    batches = [tuple(rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8)
                     for _ in range(2)) for _ in range(2)]
    zs = [{k: [rng.randn(b, vcfg.gen.style_dim).astype(np.float32) for _ in range(3)]
           for k in ("dis", "gen")} for _ in range(2)]

    def flat(tensors):
        return {n: torch.cat([t.detach().flatten() for _, t in sorted(tensors[n].items())])
                for n in GEN_NAMES}

    def run(device):
        model = _train_model(vcfg, device)
        live0 = flat({n: dict(model.gen(n).named_parameters()) for n in GEN_NAMES})
        seen, counts = [flat(model.ema)], []
        for (xa, xb), z, do_gen in zip(batches, zs, (True, False)):
            K.launches = K.bwd_launches = 0
            m = model.train_step(xa, xb, True, do_gen, z=z)
            if not all(math.isfinite(float(v)) for v in m.values()):
                raise AssertionError(f"ema f32 {device}: non-finite metrics {m}")
            counts.append((K.launches, K.bwd_launches))
            seen.append(flat(model.ema))
            if do_gen:
                live = flat({n: dict(model.gen(n).named_parameters()) for n in GEN_NAMES})
        return seen, live0, live, counts

    def ema_form(ema, weights):  # the trainer's update, in its float32 order
        return ema.clone().mul_(decay).add_(weights, alpha=1.0 - decay)

    def max_abs(t):
        return float(t.double().abs().max())

    got, live0, live, counts = run("cuda")
    if counts != [(2 * K1_PER_STEP, K2_PER_G_STEP), (K1_PER_STEP, 0)]:
        raise AssertionError(f"ema f32: (K1, K2) launches {counts}")
    out = {"counts": counts, "order": {}, "movement": {}, "live_movement": {},
           "sign_flips": {}}
    for n in GEN_NAMES:
        scale = (1.0 - decay) * max_abs(live[n] - live0[n])
        out["order"][n] = {"stepped": max_abs(got[1][n] - ema_form(got[0][n], live[n])),
                           "before_the_step": max_abs(got[1][n] - ema_form(got[0][n], live0[n])),
                           "scale": scale}
    unmoved = all(torch.equal(got[2][n], got[1][n]) for n in GEN_NAMES)
    if not unmoved or any(o["scale"] == 0.0 or o["stepped"] > 1e-2 * o["scale"]
                          or o["before_the_step"] < 0.5 * o["scale"]
                          for o in out["order"].values()):
        raise AssertionError(f"ema f32: EMA after the G step against d*EMA + (1-d)*weights, "
                             f"stepped and from before the step, beside (1-d)*max|step| "
                             f"{out['order']}; the D iteration "
                             f"{'left it' if unmoved else 'moved it'}")
    want, want_live0, want_live, _ = run("cpu")

    def rel(g, w):
        g, w = g.double().cpu(), w.double().cpu()
        return float((g - w).norm() / w.norm())

    for n in GEN_NAMES:
        out["movement"][n] = rel(got[1][n] - got[0][n], want[1][n] - want[0][n])
        step, want_step = live[n] - live0[n], want_live[n] - want_live0[n]
        out["live_movement"][n] = rel(step, want_step)
        out["sign_flips"][n] = float((torch.sign(step.cpu()) != torch.sign(want_step))
                                     .double().mean())
    if max(out["movement"].values()) > MOVE_TOL_GEN:
        raise AssertionError(f"ema f32: EMA movement card vs CPU {out}")
    return out


def _releases_follow_writes(events):
    """Checks the train CLI's order of grid / snapshot writes and host-heap
    releases: every run of writes ends in exactly one release, and no
    release comes without writes before it. Returns the number of releases."""
    releases, pending = 0, False
    for e in events:
        if e == "release":
            if not pending:
                raise AssertionError(f"acceptance_mini: a host-heap release with no write "
                                     f"before it: {events}")
            releases, pending = releases + 1, False
        else:
            pending = True
    if pending or not releases:
        raise AssertionError(f"acceptance_mini: writes with no host-heap release after them: "
                             f"{events}")
    return releases


HEAP_BLOCKS, HEAP_BLOCK = 64, 6 << 20   # the retained heap of `_heap_release_check`


def _heap_release_check():
    """Freed 6 MiB blocks kept resident by glibc's heap, then handed back by
    `release_host_heap`: a freed 16 MiB block raises the dynamic mmap
    threshold, so the blocks come from the heap, and a small live
    allocation after each pins them; the heap is released before the
    blocks, so they add VmRSS in full and what the release gives back is
    what this check freed. Returns the MiB of VmRSS the blocks added, the
    frees gave back and the release gave back."""
    from aclgan_tpu_torch.utils.hostmem import release_host_heap, vmrss

    np.ones(16 << 20, np.uint8)
    if not release_host_heap():
        raise AssertionError("acceptance_mini: this host's C library has no malloc_trim")
    base = vmrss()
    blocks, pins = [], []
    for _ in range(HEAP_BLOCKS):
        blocks.append(np.ones(HEAP_BLOCK, np.uint8))
        pins.append(bytearray(1 << 16))
    r0 = vmrss()
    del blocks
    r1 = vmrss()
    release_host_heap()
    r2 = vmrss()
    del pins
    added, kept, released = (r0 - base) / 2**20, (r0 - r1) / 2**20, (r1 - r2) / 2**20
    want = HEAP_BLOCKS * HEAP_BLOCK / 2**20
    if added < 0.9 * want or kept > added / 2 or released < added / 2:
        raise AssertionError(f"acceptance_mini: {want:.0f} MiB of blocks added {added:.1f} MiB "
                             f"of VmRSS, their frees gave back {kept:.1f}, the host-heap "
                             f"release {released:.1f} (bars: at least 90% added, at most half "
                             f"given back by the frees, at least half by the release)")
    return added, kept, released


def phase_acceptance_mini(cfg, tmp, inc):
    """[acceptance_mini] `tools/torch_synthfaces_hard.py --smoke` on phase 11's
    dataset and phase 12's classifier: the train CLI at batch 16 with EMA,
    20 iterations then `--resume` to 40 (snapshots at 20 and 40), each call
    followed by both FID curves (n 64, 2 styles, 20 resamples; the second
    sweep of each resumes with `--start_after 20`), and `report`, which must
    refuse the recorded curves (n 500) and accept gen against ema. Then the
    f32 EMA check on the card against the CPU. Returns {path: (K1, K2)}."""
    from aclgan_tpu_torch.config import load_config
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    tool = _acceptance_tool()
    smoke, decay = tool.SMOKE, load_config(tool.SHIPPED).tpu.ema_decay
    work = Path(tmp) / "acceptance"
    base = ["--smoke", "--work", str(work), "--data_root", str(Path(tmp) / "ds"),
            "--inception_weights", inc]
    train_k, curve_k = [0, 0], [0, 0]
    curve_seconds, sqrtm_seconds, train_s, lines, releases = [], [], [], [], []
    from aclgan_tpu_torch.cli import train as cli_train
    from aclgan_tpu_torch.utils.hostmem import vmrss

    write_2images, save_checkpoint = cli_train.write_2images, cli_train.save_checkpoint
    release_host_heap = cli_train.release_host_heap

    def recorded(kind, fn):
        def call(*args, **kwargs):
            events.append(kind)
            return fn(*args, **kwargs)
        return call

    def release_and_measure():
        before = vmrss()
        out = release_host_heap()
        events.append("release")
        gave.append((before - vmrss()) / 2**20)
        return out

    for i, iters in enumerate(ACC_ITERS):
        K.launches = K.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats()
        events, gave = [], []
        release_host_heap()  # what the CLI's releases give back is then its own
        with mock.patch.object(cli_train, "write_2images", recorded("grid", write_2images)), \
                mock.patch.object(cli_train, "save_checkpoint",
                                  recorded("snapshot", save_checkpoint)), \
                mock.patch.object(cli_train, "release_host_heap", release_and_measure):
            seg = tool.main(["train", *base, "--iters", str(iters)])["train"]
        torch.cuda.synchronize()
        got = (K.launches, K.bwd_launches)
        derived = (seg["derived"]["k1"], seg["derived"]["k2"])
        if got != derived or seg["start"] != (ACC_ITERS[i - 1] if i else 0):
            raise AssertionError(f"acceptance_mini train to {iters}: from {seg['start']}, "
                                 f"(K1, K2) {got}, derived {derived}")
        releases.append((_releases_follow_writes(events), [round(g, 1) for g in gave]))
        train_k = [a + b for a, b in zip(train_k, got)]
        train_s.append(seg["seconds"])
        lines += seg["iteration_lines"]
        peak = torch.cuda.max_memory_allocated()
        K.launches = K.bwd_launches = 0
        sweeps = tool.main(["curves", *base])["curves"]
        torch.cuda.synchronize()
        got = (K.launches, K.bwd_launches)
        derived = tuple(sum(sweeps[p]["derived"][k] for p in sweeps) for k in ("k1", "k2"))
        resumed = all(("--start_after" in sweeps[p]["argv"]) == bool(i) for p in sweeps)
        if got != derived or not resumed or len(sweeps) != 2:
            raise AssertionError(f"acceptance_mini curves after {iters}: (K1, K2) {got}, "
                                 f"derived {derived}, argv "
                                 f"{[sweeps[p].get('argv') for p in sweeps]}")
        curve_k = [a + b for a, b in zip(curve_k, got)]
        curve_seconds += sweeps["gen"]["seconds_a_snapshot"]
        sqrtm_seconds += sweeps["gen"]["fid_seconds"] + sweeps["ema"]["fid_seconds"]
    ckpt = work / "run" / "outputs" / "synthfaces_hard" / "checkpoints"
    files = {p: tool.snapshot_stamps(ckpt, p) for p in ("gen", "dis", "ema")}
    if any(v != list(ACC_ITERS) for v in files.values()):
        raise AssertionError(f"acceptance_mini snapshots: {files}")
    recs = _records(work / "run" / "logs" / "synthfaces_hard")
    _check_records(recs, range(10, ACC_ITERS[-1] + 1, 10), "acceptance_mini")
    docs = {p: json.loads((work / "run" / "outputs" / "synthfaces_hard" /
                           f"fid_curve_{p}.json").read_text()) for p in ("gen", "ema")}
    rows = {p: _curve_checks(d, ACC_ITERS) for p, d in docs.items()}
    try:
        tool.main(["report", *base, "--recorded", str(ROOT / "docs" / "run_synthfaces_hard")])
        raise AssertionError("acceptance_mini: report took the recorded curves (n 500) "
                             f"against n {smoke.curve_n}")
    except SystemExit as e:
        if "protocol mismatch on 'n'" not in str(e):
            raise
        refusal = str(e)
    summary = tool.main(["report", *base])["report"]
    grid = work / "docs" / summary["selected"].get("grid", "missing")
    if not grid.is_file() or set(summary["gen_against_ema"]["wins"]) != {"gen", "ema"}:
        raise AssertionError(f"acceptance_mini report: {summary['selected']}, "
                             f"{summary['gen_against_ema']}")
    t_ema = time.time()
    ema = _ema_card_vs_cpu(cfg, decay)
    ema_s = time.time() - t_ema
    heap = _heap_release_check()
    s_it = [secs / 10 for _, secs in lines]
    log(f"[acceptance_mini] tools/torch_synthfaces_hard.py --smoke: the train CLI on "
        f"configs/synthfaces_hard.yaml (EMA {decay}, batch 16, bf16) on phase 11's "
        f"JPEGs, {ACC_ITERS[0]} iterations then --resume to {ACC_ITERS[-1]}: "
        f"{' + '.join(f'{x:.1f}' for x in train_s)} s, s per iteration over each 10 "
        f"{[round(x, 4) for x in s_it]}, peak memory {peak / 2**30:.3f} GiB; (K1, K2) "
        f"{tuple(train_k)} = the cadence's count; snapshots {files['gen']} (gen, dis, ema); "
        f"{len(recs)} finite records; host-heap releases, one after each run of writes, "
        f"and the MiB of VmRSS each gave back: {releases}")
    log(f"[acceptance_mini] host heap: {HEAP_BLOCKS} blocks of {HEAP_BLOCK >> 20} MiB behind "
        f"small live ones added {heap[0]:.1f} MiB of VmRSS, their frees gave back "
        f"{heap[1]:.1f}, release_host_heap {heap[2]:.1f} (bars: at least 90% added, at most "
        f"half given back by the frees, at least half by the release)")
    for p in ("gen", "ema"):
        log(f"[acceptance_mini] fid_curve --prefix {p} (n {smoke.curve_n}, {smoke.styles} "
            f"styles, {smoke.bootstrap} resamples; cut after its first row, resumed with "
            f"--start_after "
            f"{ACC_ITERS[0]}): rows {json.dumps(rows[p])}")
    log(f"[cli.fid_curve] bfloat16, n {smoke.curve_n}, {smoke.styles} styles, "
        f"{smoke.bootstrap} bootstrap resamples, "
        f"gen then ema over 2 snapshots each: {curve_k[0]} K1 launches; seconds a gen "
        f"snapshot {', '.join(f'{x:.2f}' for x in curve_seconds)}; scipy sqrtm 2048^2 "
        f"{', '.join(f'{x:.2f}' for x in sqrtm_seconds)} s")
    log(f"[acceptance_mini] report: the recorded curves refused ({refusal[:90]}...); gen "
        f"against ema {summary['gen_against_ema']}; grid {grid.name} "
        f"({grid.stat().st_size} B)")
    log(f"[acceptance_mini] f32 EMA {decay}, 128^2 batch 2, D+G then D on the card vs "
        f"the CPU: (K1, K2) {ema['counts']}; EMA after the G step off d*EMA + (1-d)*weights "
        f"in float32, max |diff| with the stepped / the initial weights against "
        f"(1-d)*max|step|: "
        + ", ".join(f"{n} {o['stepped']:.2e} / {o['before_the_step']:.2e} against "
                    f"{o['scale']:.2e}" for n, o in ema["order"].items())
        + "; unmoved by the D iteration; EMA movement rel-L2 "
        + ", ".join(f"{n} {ema['movement'][n]:.2e}" for n in ema["movement"])
        + " (the live weights' " + ", ".join(f"{n} {ema['live_movement'][n]:.2e}"
                                             for n in ema["live_movement"])
        + "; steps of another sign " + ", ".join(f"{n} {ema['sign_flips'][n]:.2e}"
                                                 for n in ema["sign_flips"])
        + f") ({ema_s:.1f} s)")
    return {f"acceptance_mini: train CLI with EMA at batch 16 on JPEGs, {ACC_ITERS[0]} + "
            f"{ACC_ITERS[-1] - ACC_ITERS[0]} resumed iterations (phase 28)": tuple(train_k),
            f"acceptance_mini: cli.fid_curve gen + ema, 2 snapshots x {smoke.styles} styles x "
            f"{smoke.curve_n} images, cut and resumed (phase 28)": tuple(curve_k),
            "acceptance_mini: f32 D+G then D iteration with EMA, 128^2 batch 2 (phase 28)":
            tuple(map(sum, zip(*ema["counts"])))}


def _mark(phases, since):
    """Log the seconds since `since` of `phases` and the device's memory
    after them; returns the time now."""
    now = time.time()
    free, total = torch.cuda.mem_get_info()
    log(f"[phase {phases}] {now - since:.1f} s; device memory after it: allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.3f}, free {free / 2**30:.3f} of "
        f"{total / 2**30:.3f}")
    return now


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    if not (ROOT / "aclgan_tpu_torch").is_dir() or not (ROOT / "configs").is_dir():
        log(f"chip_smoke: {ROOT} is not a checkout of the repository")
        return 2
    sys.path.insert(0, str(ROOT))
    from aclgan_tpu_torch.config import load_config
    from aclgan_tpu_torch.trainer import ACLGAN
    from aclgan_tpu_torch.utils.checkpoint import save_generators

    t_start = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} visible")
    log(smi)

    t = time.time()
    phase_build()
    t = _mark(2, t)
    k1, k1_device = phase_instance_norm_kernel()
    k2, k2_device = phase_instance_norm_bwd_kernel()
    torch.cuda.empty_cache()
    t = _mark("3-4", t)

    cfg = load_config(CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "gen_00000000.pt")
        save_generators(ckpt, ACLGAN(cfg, device="cuda", seed=0))
        outs32 = phase_translator_f32(cfg, ckpt)
        outs16 = phase_translator_bf16(cfg, ckpt, outs32)
        torch.cuda.empty_cache()
        t = _mark("5-6", t)
        phase_train_f32(cfg)
        torch.cuda.empty_cache()
        t = _mark(7, t)
        (k1["launches"], k2["launches"]), bare_s_per_it = phase_train_bf16(cfg)
        by_path = {"train_step, one D+G iteration at batch 16 (phase 8)":
                   (k1["launches"], k2["launches"])}
        torch.cuda.empty_cache()
        t = _mark(8, t)
        cli_b3_s, by_path["train CLI, 40 iterations at batch 3 (phase 9)"] = \
            phase_train_cli_b3(cfg, tmp)
        gc_collect()
        t = _mark(9, t)
        cli16_s_per_it, by_path["train CLI, 30 iterations at batch 16 (phase 10)"] = \
            phase_train_cli_b16(cfg, tmp, bare_s_per_it)
        gc_collect()
        t = _mark(10, t)
        phase_dataset(tmp)
        inc = phase_train_inception(tmp)
        torch.cuda.empty_cache()
        t = _mark("11-12", t)
        by_path["cli.test, one image x 10 styles, f32 (phase 13)"] = \
            phase_cli_test(cfg, tmp, ckpt)
        by_path[f"cli.test_batch, 64 images at batch {EVAL_BATCH} x {EVAL_STYLES} styles "
                "(phase 14)"] = phase_cli_test_batch(cfg, tmp, ckpt, inc)
        torch.cuda.empty_cache()
        t = _mark("13-14", t)
        by_path[f"BucketedTranslator, {N_BUCKETED} requests over buckets {BUCKETS} "
                "(phase 16)"] = phase_bucketed(cfg, ckpt)
        torch.cuda.empty_cache()
        by_path[f"ExportedTranslator, {N_REQUESTS} requests at batch {BATCH} "
                "(phase 17)"] = phase_export(cfg, ckpt, tmp, outs16)
        torch.cuda.empty_cache()
        t = _mark("16-17", t)
        by_path[f"HTTP front, levels {HTTP_LEVELS} + artifact at 8, batch {HTTP_BATCH} "
                "(phase 18)"] = phase_http(cfg, ckpt, tmp)
        gc_collect()
        t = _mark(18, t)
        for phase, fn in ((19, lambda: phase_variants_f32(cfg)),
                          (20, lambda: phase_remat_bf16(cfg)),
                          (21, lambda: phase_jax_resume(cfg, tmp))):
            t0 = time.time()
            paths = fn()
            by_path.update({f"{path}, one D+G iteration (phase {phase})" if phase < 21
                            else f"{path} (phase {phase})": c for path, c in paths.items()})
            _mark(phase, t0)
            gc_collect()
        for phase, fn, label in (
                (22, lambda: phase_native(cfg, tmp, cli16_s_per_it),
                 "train CLI on phase 11's JPEGs, 30 iterations at batch 16"),
                (23, lambda: phase_dp_two_ranks(cfg, tmp), None),
                (24, lambda: phase_ddp_cli(cfg, tmp, cli16_s_per_it)["traced"],
                 "torchrun train CLI at world 1, batch 16: kernel events over the traced "
                 "iterations 11..15"),
                (25, lambda: phase_devices(cfg, ckpt, outs16),
                 f"Translator(devices=-1), {N_REQUESTS} requests at batch {BATCH}"),
                (26, phase_vgg, f"compute_vgg_loss forward + backward, batch {VGG_BATCH}, "
                                f"{VGG_SIZE}^2")):
            t0 = time.time()
            counts = fn()
            if label is None:  # one entry a case, each rank's count
                by_path.update({f"data-parallel rank of 2, {case}, one D+G iteration at "
                                f"global batch {DP_BATCH} (phase {phase})": c
                                for case, c in counts.items()})
            else:
                by_path[f"{label} (phase {phase})"] = counts
            _mark(phase, t0)
            gc_collect()
        t0 = time.time()
        split, sp_paths = phase_spatial_two_ranks(cfg, tmp, smi)
        by_path.update(sp_paths)
        _mark(27, t0)
        gc_collect()
        t0 = time.time()
        by_path.update(phase_acceptance_mini(cfg, tmp, inc))
        _mark(28, t0)
        gc_collect()
        t0 = time.time()
        by_path.update(phase_graphs(cfg, ckpt, smi, cli_b3_s))
        _mark(29, t0)
        gc_collect()
        t0 = time.time()
        by_path.update(phase_mesh_graphs(cfg, tmp, smi, cli16_s_per_it))
        _mark(30, t0)
        t0 = time.time()
        for k, device in ((k1, k1_device), (k2, k2_device)):
            k.update(device())
        _mark(31, t0)
    for i, k in enumerate((k1, k2)):
        k["launches_by_path"] = {path: counts[i] for path, counts in by_path.items()}
    for i, k in enumerate(split, start=2):  # (K1, K2, K1m, K1a, K2m, K2a) of phase 27
        k["launches_by_path"] = {path: counts[i] for path, counts in sp_paths.items()}

    print(json.dumps({"kernels": [k1, k2] + split}), flush=True)
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [TORCHRUN_CLI]:
        sys.exit(_torchrun_cli(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == [MESH_GRAPHS]:
        sys.exit(mesh_graphs_alone(sys.argv[2:]))
    sys.exit(main())
