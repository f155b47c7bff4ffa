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
multi-replica Translator and the VGG perceptual loss, through the
hand-written CUDA kernels, and fails, with a non-zero exit, if any phase
fails:

1. device info (torch/CUDA versions, nvidia-smi name and power limit);
2. build every kernel under aclgan_tpu_torch/csrc with nvcc;
3. K1 (instance-norm forward) against its plain PyTorch version at the
   serving shapes, with timings of the kernel, the plain version and one
   library call over a Translator batch and over a D+G training iteration,
   and the host's microseconds a call through the `aclgan::` op costs
   against the bare wrapper and the wrapper under a device guard;
4. K2 (instance-norm backward) against its plain version at the training
   shapes, with the same timings over one G step;
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
   images/s, peak memory, finite losses, device time by kernel group over one
   D+G iteration, and the K1/K2 launches of one D+G iteration;
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
15. `cli.fid_curve` over phase 9's snapshots 20 and 40, 64 images, 2
   styles, 20 bootstrap resamples: rows with the JAX tool's keys, finite
   FIDs and intervals, 19 K1 launches a snapshot a style, seconds a snapshot;
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
   256^2 JPEGs at concurrency 1, 8, 32 and 48, then 8 over `--artifact`
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
   batch 64 under remat all, under grad_accum 4 and without either (its OOM
   printed as such); bf16 moments at 16: it/s and the optimizer's bytes;
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
24. [ddp_cli] `python -m torch.distributed.run --nproc_per_node 1 -m
   aclgan_tpu_torch.cli.train` with `tpu.distributed: true` (NCCL) on the
   shipped config, synthetic, batch 16, bf16: 30 iterations traced at 10..14,
   then `--resume` to 35: p50 s per iteration against phase 10, the trace's
   K1 / K2 events (equal to the traced steps' count), the records and the
   snapshot files;
25. [devices] `Translator(devices=-1)`: outputs equal to phase 6's; devices=2
   raises the JAX message with one card visible;
26. [vgg] `compute_vgg_loss` at 256^2, batch 16, f32: loss and image
   gradients against the plain instance norm (rel 1e-4), ms a loss, (K1, K2)
   a loss (2, 2);
27. one JSON line listing every kernel;
28. last line: {"ok": true, "device": {...}}.

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


def _encode_mix(n):
    """The content encoder's IN layers at batch n (male2female, 256^2)."""
    return [((n, 64, 256, 256), False, 1), ((n, 128, 128, 128), False, 1),
            ((n, 256, 64, 64), False, 9)]


def _decode_mix(n):
    """The decoder's AdaIN layers at batch n."""
    return [((n, 256, 64, 64), True, 8)]


def _g_step_mix(b):
    """Instance-norm layers of one G step at batch b: gen_AB encodes x_a||x_b,
    gen_BA encodes x_a and x_B_fake, gen_AB decodes 2b, gen_BA decodes 3b."""
    return (_encode_mix(2 * b) + _encode_mix(b) + _encode_mix(b)
            + _decode_mix(2 * b) + _decode_mix(3 * b))


def _d_step_mix(b):
    """Instance-norm layers of one D step at batch b (no x_b, no self-recons)."""
    return _encode_mix(b) * 3 + _decode_mix(b) + _decode_mix(2 * b)


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


def phase_build():
    from aclgan_tpu_torch.ops.kernels import build

    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    t0 = time.time()
    logs = build.build_all(sources)
    log(f"[build] {sources} in {time.time() - t0:.2f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")


def _time_mix(tag, mix, make, run, plain, library, nbytes, flops_per_element):
    """Kernel, plain and library ms of a list of (shape, affine, count) layers,
    each shape timed once and counted `count` times; also the bytes bound."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    for shape, affine, count in mix:
        args = make(shape, affine)
        ms, plain_ms, library_ms = (time_ms(lambda f=f: f(*args))
                                    for f in (run, plain, library))
        b = nbytes(shape, affine)
        flops = flops_per_element * math.prod(shape)
        bound = max(b / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        log(f"[kernel] {tag} bf16 {shape} affine={affine} x{count}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound:.4f} ms, "
            f"{b / ms / 1e6:.0f} GB/s")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("bytes", b), ("flops", flops)):
            tot[key] += count * val
        del args
    bytes_ms = tot["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = tot["flops"] / F32_FLOPS_PER_S * 1e3
    tot["bound_ms"] = max(bytes_ms, ops_ms)
    tot["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return tot


def _log_total(tag, work, tot):
    log(f"[kernel] {tag} per {work}: kernel {tot['ms']:.4f} ms, plain "
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


def phase_instance_norm_kernel():
    """K1 against its plain version; returns its kernels-line entry."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    g = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for shape in MAIN_SHAPES:
        n, c = shape[:2]
        base = torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.5
        scale = torch.randn(n, c, device="cuda", generator=g)
        shift = torch.randn(n, c, device="cuda", generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype)
            for affine in (False, True):
                for activ in ("none", "relu", "lrelu", "tanh"):
                    args = (scale, shift) if affine else (None, None)
                    got = K.fused_instance_norm(x, *args, activ=activ).float()
                    torch.cuda.synchronize()
                    want = K.instance_norm_plain(x, *args, activ=activ).float()
                    err = (got - want).abs()
                    tol = TOL[dtype]
                    bad = (err > tol + tol * want.abs()).sum().item()
                    max_err = max(max_err, err.max().item())
                    if bad or not torch.isfinite(got).all():
                        raise AssertionError(
                            f"instance_norm {shape} {dtype} affine={affine} {activ}: "
                            f"{bad} elements beyond tol {tol}, max err {err.max().item()}")
            del x
        log(f"[kernel] instance_norm {shape}: 16 cases within tolerance")
        del base

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

    def plain(x, scale, shift, *_):
        return K.instance_norm_plain(x, scale, shift, activ="relu")

    def library(x, scale, shift, xv, wv, bv):
        return F.instance_norm(xv, weight=wv, bias=bv, eps=1e-5)

    def nbytes(shape, affine):  # read x, write y (+ the f32 scale and shift)
        return 2 * 2 * math.prod(shape) + (2 * 4 * shape[0] * shape[1] if affine else 0)

    _op_overhead()
    # serving: per Translator batch of 32, IN at 256^2 x64 once, 128^2 x128
    # once, 64^2 x256 nine times, AdaIN at 64^2 x256 eight times
    serving = _time_mix("instance_norm", _encode_mix(BATCH) + _decode_mix(BATCH), make,
                        run, plain, library, nbytes, 10.0)
    _log_total("instance_norm", f"bf16 Translator batch of {BATCH} ({LAUNCHES_PER_BATCH} "
               "launches)", serving)
    train = _time_mix("instance_norm", _d_step_mix(TRAIN_BATCH) + _g_step_mix(TRAIN_BATCH),
                      make, run, plain, library, nbytes, 10.0)
    _log_total("instance_norm", f"bf16 D+G iteration at batch {TRAIN_BATCH} "
               f"({2 * K1_PER_STEP} launches)", train)
    return dict(
        name="instance_norm_fwd", route="cuda",
        source="aclgan_tpu_torch/csrc/instance_norm.cu",
        replaces="aclgan_tpu/ops/pallas/instance_norm.py:67",
        launches=None, max_abs_err=max_err,
        ms=train["ms"], plain_ms=train["plain_ms"], bound_ms=train["bound_ms"],
        bound_by=train["bound_by"], library_ms=train["library_ms"],
        library="F.instance_norm on the (1, N*C, H, W) view (no activation)",
        work=f"one bf16 D+G training iteration at batch {TRAIN_BATCH}, 256^2: "
             f"{2 * K1_PER_STEP} launches; per Translator batch of {BATCH}: "
             f"{serving['ms']:.4f} ms (bound {serving['bound_ms']:.4f})")


def phase_instance_norm_bwd_kernel():
    """K2 against its plain version at the training shapes; returns its
    kernels-line entry."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    g = torch.Generator(device="cuda").manual_seed(1)
    max_err = {"dx": 0.0, "dscale": 0.0, "dshift": 0.0}
    for shape in TRAIN_SHAPES:
        n, c = shape[:2]
        base = torch.randn(shape, device="cuda", generator=g) * 2.0 + 0.5
        dy_base = torch.randn(shape, device="cuda", generator=g)
        scale = torch.randn(n, c, device="cuda", generator=g)
        shift = torch.randn(n, c, device="cuda", generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = base.to(dtype), dy_base.to(dtype)
            tol = TOL[dtype]
            for affine in (False, True):
                for activ in ("none", "relu", "lrelu", "tanh"):
                    args = (scale, shift) if affine else (None, None)
                    y = K.fused_instance_norm(x, *args, activ=activ)
                    got = K.instance_norm_bwd(x, args[0], y, dy, 1e-5, activ)
                    torch.cuda.synchronize()
                    want = K.instance_norm_bwd_plain(x, args[0], y, dy, 1e-5, activ)
                    for name, o, w in zip(max_err, got, want):
                        if not affine and name != "dx":  # IN: no dscale, dshift
                            continue
                        o, w = o.float(), w.float()
                        err = (o - w).abs()
                        max_err[name] = max(max_err[name], err.max().item())
                        # dx elementwise as K1; the row sums against their largest
                        lim = tol + tol * w.abs() if name == "dx" else tol * w.abs().max()
                        bad = (err > lim).sum().item()
                        if bad or not torch.isfinite(o).all():
                            raise AssertionError(
                                f"instance_norm_bwd {shape} {dtype} affine={affine} "
                                f"{activ} {name}: {bad} elements beyond tolerance, max "
                                f"err {err.max().item()}")
                    del y, got, want
            del x, dy
        log(f"[kernel] instance_norm_bwd {shape}: 16 cases within tolerance (dx, "
            f"dscale, dshift)")
        del base, dy_base
    log(f"[kernel] instance_norm_bwd max abs err: " + ", ".join(
        f"{k} {v:.3g}" for k, v in max_err.items()))

    def make(shape, affine):
        n, c, h, w = shape
        x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        scale = torch.randn(n, c, device="cuda", generator=g) if affine else None
        shift = torch.randn(n, c, device="cuda", generator=g) if affine else None
        y = K.fused_instance_norm(x, scale, shift, activ="relu")
        dy = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        # the library call gets the stats from a forward; it does not redo them
        xv, dyv = x.view(1, n * c, h, w), dy.view(1, n * c, h, w)
        wv = None if scale is None else scale.flatten()
        _, mean, invstd = torch.ops.aten.native_batch_norm(
            xv, wv, None if shift is None else shift.flatten(), None, None, True, 0.0,
            1e-5)
        return x, scale, y, dy, xv, dyv, wv, mean, invstd, [True, affine, affine]

    def run(x, scale, y, dy, *_):
        return K.instance_norm_bwd(x, scale, y, dy, 1e-5, "relu")

    def plain(x, scale, y, dy, *_):
        return K.instance_norm_bwd_plain(x, scale, y, dy, 1e-5, "relu")

    def library(x, scale, y, dy, xv, dyv, wv, mean, invstd, mask):
        return torch.ops.aten.native_batch_norm_backward(
            dyv, xv, wv, None, None, mean, invstd, True, 1e-5, mask)

    def nbytes(shape, affine):  # read x, y, dy, write dx (+ scale, dscale, dshift)
        return 4 * 2 * math.prod(shape) + (3 * 4 * shape[0] * shape[1] if affine else 0)

    tot = _time_mix("instance_norm_bwd", _g_step_mix(TRAIN_BATCH), make, run, plain,
                    library, nbytes, 20.0)
    _log_total("instance_norm_bwd", f"bf16 G step at batch {TRAIN_BATCH} "
               f"({K2_PER_G_STEP} launches)", tot)
    return dict(
        name="instance_norm_bwd", route="cuda",
        source="aclgan_tpu_torch/csrc/instance_norm.cu",
        replaces="aclgan_tpu/ops/pallas/instance_norm.py:102",
        launches=None, max_abs_err=max(max_err.values()),
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by=tot["bound_by"], library_ms=tot["library_ms"],
        library="aten.native_batch_norm_backward on the (1, N*C, H, W) view, given "
                "saved stats, no activation gate",
        work=f"one bf16 G step at batch {TRAIN_BATCH}, 256^2: {K2_PER_G_STEP} launches")


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


def _profile(what, fn):
    """Device time by kernel group over one call of fn(), with torch.profiler."""
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
    log(f"[profile] {what}: {wall_ms:.2f} ms wall, "
        f"{busy:.2f} ms device busy ({100 * (1 - busy / wall_ms):.1f}% idle)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {g}: {ms:.2f} ms ({100 * ms / wall_ms:.1f}% of wall)")
    kernels.sort(reverse=True)
    for ms, count, key in kernels[:15]:
        log(f"[profile]   {ms:8.2f} ms x{count:<5d} {key[:110]}")


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
        f"peak memory {peak / 2**30:.3f} GiB ({peak} B); vs f32: max {diff.max()} LSB, "
        f"mean {diff.mean():.4f} LSB")
    if diff.mean() > 8:
        raise AssertionError(f"bf16 outputs drift {diff.mean():.2f} LSB on average from f32")
    _profile(f"one window of {len(window)} requests", lambda: tr(window, win_styles))
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


def _train_model(cfg, device, seed=0):
    from aclgan_tpu_torch.trainer import ACLGAN

    model = ACLGAN(cfg, device=device, seed=seed)
    model.init_state()
    return model


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
    """The shipped config (bf16) at 256^2, batch 16: 2 warm-up iterations, then
    5 timed windows of 8 iterations at the D1/G2 cadence (CUDA events), then
    one profiled D+G iteration. Returns the (K1, K2) launches of the first
    (D+G) iteration."""
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
        f"{peak / 2**30:.3f} GiB ({peak} B); every loss finite; last losses {last}")
    if it % cfg.G_update:
        iteration()
    # each kind of iteration alone, in turns (the step is even here, so D+G
    # comes first): device ms (CUDA events, median of 3) and the FLOPs of its
    # aten ops (convolutions forward and backward, matmuls; the instance-norm
    # kernels are not aten ops and count none)
    from torch.utils.flop_counter import FlopCounterMode

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
        counter = FlopCounterMode(display=False)
        with counter:
            iteration()
        ms, flops = float(np.median(ts)), counter.get_total_flops()
        log(f"[train bf16] one {kind} iteration: {ms:.2f} ms "
            f"({', '.join(f'{t:.2f}' for t in ts)}), {flops / 1e12:.3f} TFLOP of aten ops, "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
    _profile(f"one D+G training iteration at batch {b}", iteration)
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
    """`cli.train.main(argv)` in process; returns its stdout lines."""
    from aclgan_tpu_torch.cli.train import main as train_main

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        train_main(argv)
    return tee.lines


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
    lines = _run_cli(["--config", path, "--output_path", out, "--max_iter", "40"])
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
    lines = _run_cli(["--config", path, "--output_path", out, "--resume",
                      "--max_iter", "50"])
    _check_records(_records(log_dir), range(1, 51), "train CLI b3 resumed")
    opt = torch.load(run / "checkpoints" / "optimizer.pt", weights_only=True)
    if opt["step"] != 50 or opt["saved_iteration"] != 50:
        raise AssertionError(f"train CLI b3 resumed: step {opt['step']}")
    log(f"[train cli b3] --resume --max_iter 50: {n_tensors} restored tensors equal the "
        f"iteration-40 files bit for bit; records 41..50 appended; step 50; "
        f"{sum(bool(_ITERATION.match(x)) for x in lines)} Iteration lines")
    torch.cuda.empty_cache()
    bare = _bare_train_step(derived)
    log(f"[train cli b3] CLI {per_it:.4f} s per iteration against the bare train_step's "
        f"{bare:.4f} s: ratio {per_it / bare:.4f}")
    return per_it, launches


def _bare_train_step(cfg):
    """`train_step` alone at cfg.batch_size on device-resident batches, as phase
    8 runs it: p50 seconds per iteration over 5 windows of 8 at D1/G2 (CUDA
    events), the host's seconds to issue a window, and the device's idle
    share over one D+G iteration (torch.profiler)."""
    b = cfg.batch_size
    model = _train_model(cfg, "cuda")
    rng = np.random.RandomState(1)
    batches = [tuple(torch.from_numpy(rng.randint(0, 256, (b, 256, 256, 3), dtype=np.uint8))
                     .cuda() for _ in range(2)) for _ in range(4)]
    it = 0

    def iteration():
        nonlocal it
        xa, xb = batches[it % len(batches)]
        model.train_step(xa, xb, it % cfg.D_update == 0, it % cfg.G_update == 0)
        it += 1

    for _ in range(2):
        iteration()
    torch.cuda.synchronize()
    secs, host, window = [], [], 8
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(window):
            iteration()
        end.record()
        host.append((time.perf_counter() - t0) / window)
        torch.cuda.synchronize()
        secs.append(start.elapsed_time(end) / 1e3 / window)
    p50 = float(np.median(secs))
    log(f"[train bare b{b}] train_step at batch {b}, D1/G2: p50 {p50:.4f} s per iteration "
        f"over 5 windows of {window} ({', '.join(f'{s:.4f}' for s in secs)}); the host "
        f"issues an iteration in {float(np.median(host)):.4f} s (p50)")
    if it % cfg.G_update:
        iteration()
    _profile(f"one D+G training iteration at batch {b}", iteration)
    return p50


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
    lines = _run_cli(["--config", path, "--output_path", out, "--max_iter", "30",
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
    # setup, and the traced window (profiler on) and the iteration after it
    skip = {1} | set(range(11, 17))
    p50, per_it, counts = _cli_seconds(lines, cadence, skip)
    log(f"[train cli b16] male2female 256^2 batch {b}, {epoch_len} batches an epoch: p50 "
        f"D+G {p50['D+G']:.4f} s, D {p50['D']:.4f} s ({counts} iterations), "
        f"{per_it:.4f} s per iteration at D1/G2 = {b / per_it:.2f} img/s; bare "
        f"train_step (phase 8) {bare_s_per_it:.4f} s: ratio {per_it / bare_s_per_it:.4f}; "
        f"peak memory {peak / 2**30:.3f} GiB ({peak} B); (K1, K2) launches {launches}; "
        f"trace {size} B")
    return per_it, launches


# ------------------------------------------------------------------ evaluation
K1_PER_TRIPLET = 3 * 11 + 3 * 8   # test_batch: 3 content encodes, 3 decodes
EVAL_BATCH = 32
EVAL_STYLES = 3
FT_STEPS = 40                      # the classifier fine-tune's steps
SWEEP_STYLES = 2


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


def phase_fid_curve(cfg, tmp, run_dir, inc):
    """`cli.fid_curve` over two phase-9 snapshots; returns its (K1, K2) launches."""
    import shutil

    from aclgan_tpu_torch.cli import fid_curve
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    sweep = Path(tmp) / "sweep"
    (sweep / "checkpoints").mkdir(parents=True)
    for it in (20, 40):
        shutil.copy(Path(run_dir) / f"gen_{it:08d}.pt", sweep / "checkpoints")
    path = _eval_config(cfg, tmp, "m2f_sweep")
    K.launches = K.bwd_launches = 0
    r = fid_curve.main(["--config", path, "--run_dir", str(sweep), "--inception_weights",
                        inc, "--n", "64", "--styles", str(SWEEP_STYLES), "--bootstrap",
                        "20"])
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    if launches != (LAUNCHES_PER_BATCH * 2 * SWEEP_STYLES, 0):
        raise AssertionError(f"cli.fid_curve: (K1, K2) launches {launches}")
    doc = json.loads(Path(r["path"]).read_text())
    keys = {"iteration", "fid", "target_domain_rate", "n_fake", "n_real", "fid_styles",
            "fid_spread", "fid_ci95", "fid_f32_minus_f64"}
    rows = doc["rows"]
    if [row["iteration"] for row in rows] != [20, 40] or any(set(x) != keys for x in rows):
        raise AssertionError(f"cli.fid_curve rows: {rows}")
    vals = [v for row in rows for v in [row["fid"], row["fid_f32_minus_f64"],
                                        *row["fid_ci95"], *row["fid_styles"]]]
    if not all(math.isfinite(v) for v in vals) or not doc["complete"]:
        raise AssertionError(f"cli.fid_curve: non-finite values in {rows}")
    log(f"[cli.fid_curve] {cfg.tpu.compute_dtype}, 2 snapshots x {SWEEP_STYLES} styles, n 64, 20 bootstrap "
        f"resamples: rows {json.dumps(rows)}; {launches[0]} K1 launches; seconds a "
        f"snapshot {', '.join(f'{x:.2f}' for x in r['seconds'])}; scipy sqrtm 2048^2 "
        f"{', '.join(f'{x:.2f}' for x in r['fid_seconds'])} s")
    return launches


# ------------------------------------------------------------------ serving stack
BUCKETS = (128, 192, 256)
N_BUCKETED = 96
HTTP_BATCH = 16
HTTP_WAIT_MS = 5.0
HTTP_LEVELS = (1, 8, 32, 48)
HTTP_SECONDS = 5.0


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
    events) after one D+G and one D warm-up iteration."""
    it = cadence_start

    def iteration():
        nonlocal it
        xa, xb = batches[it % len(batches)]
        model.train_step(xa, xb, True, it % 2 == 0)
        it += 1

    for _ in range(2):
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
        f"({peak} B); (K1, K2) of a D+G iteration {launched}; optimizer state "
        f"{opt_bytes} B")
    del model, batches
    gc_collect()
    return dict(it_s=p50, peak=peak, launches=launched, opt_bytes=opt_bytes)


def phase_remat_bf16(cfg):
    """[remat_bf16] The shipped config (bf16, 256^2) at batch 16 under each
    tpu.remat family, then BIG_BATCH under remat all, under grad_accum 4 and
    without either, then bf16 moments at 16. Returns {path: (K1, K2)}."""
    b = TRAIN_BATCH
    counts = {}
    for remat in ("none", "decode", "encode", "all"):
        r = _train_probe(dataclasses.replace(cfg, tpu=dataclasses.replace(
            cfg.tpu, remat=False if remat == "none" else remat)), b, f"remat {remat}")
        want = (2 * K1_PER_STEP + REMAT_EXTRA[remat], K2_PER_G_STEP)
        if r is None or r["launches"] != want:
            raise AssertionError(f"remat_bf16 {remat}: {r}, expected launches {want}")
        counts[f"remat {remat}"] = r["launches"]
    for tag, tpu in (("remat all", dict(remat="all")), ("grad_accum 4", dict(grad_accum=4)),
                     ("remat none", {})):
        r = _train_probe(dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, **tpu)),
                         BIG_BATCH, tag)
        if r is not None:
            accum = tpu.get("grad_accum", 1)
            want = (accum * (2 * K1_PER_STEP + REMAT_EXTRA["all" if "remat" in tpu else
                                                           "none"]), accum * K2_PER_G_STEP)
            if r["launches"] != want:
                raise AssertionError(f"remat_bf16 {tag} at {BIG_BATCH}: launches "
                                     f"{r['launches']}")
            counts[f"{tag}, batch {BIG_BATCH}"] = r["launches"]
        elif tag != "remat none":  # only the un-remat'ed big batch may not fit
            raise AssertionError(f"remat_bf16: {tag} at batch {BIG_BATCH} did not fit")
    f32 = _train_probe(cfg, b, "moments float32 (for the optimizer bytes)")
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
    lines = _run_cli(["--config", str(path), "--output_path", str(out), "--max_iter", "30"])
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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
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


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def phase_dp_two_ranks(cfg, tmp):
    """[dp_two_ranks] Two processes on the one card over gloo with CUDA
    tensors, one D+G iteration at phase 7's cut (f32, TF32 off, 128^2, global
    batch 4, 2 a rank) for dis in and dis bn, against the single-process step
    at batch 4. Returns {case: (K1, K2) of each rank}."""
    import torch.multiprocessing as mp

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
    mp.start_processes(_dp_rank, args=(DP_WORLD, _free_port(), cases, str(out_dir)),
                       nprocs=DP_WORLD, join=True, start_method="spawn")
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


def _trace_launches(trace):
    """(K1, K2) kernel events in a chrome trace of torch.profiler."""
    events = json.loads(Path(trace).read_text()).get("traceEvents", [])
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return (sum("instance_norm_fwd" in k for k in kernels),
            sum("instance_norm_bwd" in k for k in kernels))


def phase_ddp_cli(cfg, tmp, cli_s_per_it):
    """[ddp_cli] `torch.distributed.run --nproc_per_node 1 -m
    aclgan_tpu_torch.cli.train` with `tpu.distributed: true` (NCCL) on the
    shipped config, synthetic, batch 16, bf16: 30 iterations traced at
    10..14, then `--resume` to 35; s/it p50 against phase 10's single process.
    Returns the (K1, K2) kernel events of the traced window."""
    b = TRAIN_BATCH
    derived, path = _cli_config(cfg, tmp, "m2f_ddp", batch_size=b,
                                tpu=dataclasses.replace(cfg.tpu, distributed=True))
    out, prof_dir = Path(tmp) / "ddp", Path(tmp) / "ddp_trace"
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1", "-m", "aclgan_tpu_torch.cli.train", "--config", path,
            "--output_path", str(out)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))

    def run(extra):
        t0 = time.time()
        proc = subprocess.run(base + extra, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode:
            raise RuntimeError(f"ddp_cli {extra}: exit {proc.returncode}\n"
                               f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        return proc.stdout.splitlines(), time.time() - t0

    lines, first_s = run(["--max_iter", str(DDP_ITERS), "--profile_dir", str(prof_dir)])
    if not any("1 device(s)" in line for line in lines):
        raise AssertionError("ddp_cli: no 'Training ... 1 device(s)' line")
    epoch_len = max(64, b * 8) // b
    cadence = _cadence(derived, epoch_len, 1, DDP_ITERS)
    _check_records(_records(out / "logs" / "m2f_ddp"), range(1, DDP_ITERS + 1), "ddp_cli")
    p50, per_it, counts = _cli_seconds(lines, cadence, {1} | set(range(11, 17)))
    traced = _trace_launches(prof_dir / "trace.json")
    window = _expected_launches({i: cadence[i] for i in range(11, 16)}, samples=0)
    if traced != window:
        raise AssertionError(f"ddp_cli: the trace holds (K1, K2) events {traced}, the "
                             f"traced steps launch {window}")
    resumed, resume_s = run(["--max_iter", str(DDP_RESUME_TO), "--resume"])
    if not any(line == f"Resume from iteration {DDP_ITERS}" for line in resumed):
        raise AssertionError("ddp_cli: --resume did not start from the snapshot")
    _check_records(_records(out / "logs" / "m2f_ddp"), range(1, DDP_RESUME_TO + 1),
                   "ddp_cli resumed")
    ckpts = sorted(p.name for p in (out / "outputs" / "m2f_ddp" / "checkpoints").iterdir())
    want_ckpts = sorted(f"{k}_{i:08d}.pt" for k in ("gen", "dis")
                        for i in (DDP_ITERS, DDP_RESUME_TO)) + ["optimizer.pt"]
    if ckpts != sorted(want_ckpts):
        raise AssertionError(f"ddp_cli: snapshot files {ckpts}")
    log(f"[ddp_cli] torchrun --nproc_per_node 1, tpu.distributed (NCCL), male2female 256^2 "
        f"batch {b} bf16: p50 D+G {p50['D+G']:.4f} s, D {p50['D']:.4f} s ({counts} "
        f"iterations), {per_it:.4f} s per iteration; single process (phase 10) "
        f"{cli_s_per_it:.4f} s: ratio {per_it / cli_s_per_it:.4f}; traced (K1, K2) kernel "
        f"events over iterations 11..15 {traced} (their steps launch {window}); "
        f"{DDP_ITERS} iterations {first_s:.1f} s and --resume to {DDP_RESUME_TO} "
        f"{resume_s:.1f} s wall with start-up; files {ckpts}")
    return traced


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

    phase_build()
    k1 = phase_instance_norm_kernel()
    k2 = phase_instance_norm_bwd_kernel()
    torch.cuda.empty_cache()

    cfg = load_config(CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "gen_00000000.pt")
        save_generators(ckpt, ACLGAN(cfg, device="cuda", seed=0))
        outs32 = phase_translator_f32(cfg, ckpt)
        outs16 = phase_translator_bf16(cfg, ckpt, outs32)
        torch.cuda.empty_cache()
        phase_train_f32(cfg)
        torch.cuda.empty_cache()
        (k1["launches"], k2["launches"]), bare_s_per_it = phase_train_bf16(cfg)
        by_path = {"train_step, one D+G iteration at batch 16 (phase 8)":
                   (k1["launches"], k2["launches"])}
        torch.cuda.empty_cache()
        _, by_path["train CLI, 40 iterations at batch 3 (phase 9)"] = \
            phase_train_cli_b3(cfg, tmp)
        torch.cuda.empty_cache()
        cli16_s_per_it, by_path["train CLI, 30 iterations at batch 16 (phase 10)"] = \
            phase_train_cli_b16(cfg, tmp, bare_s_per_it)
        torch.cuda.empty_cache()
        phase_dataset(tmp)
        inc = phase_train_inception(tmp)
        torch.cuda.empty_cache()
        by_path["cli.test, one image x 10 styles, f32 (phase 13)"] = \
            phase_cli_test(cfg, tmp, ckpt)
        by_path[f"cli.test_batch, 64 images at batch {EVAL_BATCH} x {EVAL_STYLES} styles "
                "(phase 14)"] = phase_cli_test_batch(cfg, tmp, ckpt, inc)
        torch.cuda.empty_cache()
        run_dir = Path(tmp) / "b3" / "outputs" / "m2f_b3" / "checkpoints"
        by_path[f"cli.fid_curve, 2 snapshots x {SWEEP_STYLES} styles x 64 images "
                "(phase 15)"] = phase_fid_curve(cfg, tmp, run_dir, inc)
        torch.cuda.empty_cache()
        by_path[f"BucketedTranslator, {N_BUCKETED} requests over buckets {BUCKETS} "
                "(phase 16)"] = phase_bucketed(cfg, ckpt)
        torch.cuda.empty_cache()
        by_path[f"ExportedTranslator, {N_REQUESTS} requests at batch {BATCH} "
                "(phase 17)"] = phase_export(cfg, ckpt, tmp, outs16)
        torch.cuda.empty_cache()
        by_path[f"HTTP front, levels {HTTP_LEVELS} + artifact at 8, batch {HTTP_BATCH} "
                "(phase 18)"] = phase_http(cfg, ckpt, tmp)
        torch.cuda.empty_cache()
        for phase, fn in ((19, lambda: phase_variants_f32(cfg)),
                          (20, lambda: phase_remat_bf16(cfg)),
                          (21, lambda: phase_jax_resume(cfg, tmp))):
            t0 = time.time()
            paths = fn()
            by_path.update({f"{path}, one D+G iteration (phase {phase})" if phase < 21
                            else f"{path} (phase {phase})": c for path, c in paths.items()})
            log(f"[phase {phase}] {time.time() - t0:.1f} s")
            gc_collect()
        for phase, fn, label in (
                (22, lambda: phase_native(cfg, tmp, cli16_s_per_it),
                 "train CLI on phase 11's JPEGs, 30 iterations at batch 16"),
                (23, lambda: phase_dp_two_ranks(cfg, tmp), None),
                (24, lambda: phase_ddp_cli(cfg, tmp, cli16_s_per_it),
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
            log(f"[phase {phase}] {time.time() - t0:.1f} s")
            gc_collect()
    for i, k in enumerate((k1, k2)):
        k["launches_by_path"] = {path: counts[i] for path, counts in by_path.items()}

    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
