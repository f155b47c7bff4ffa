#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`aclgan_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths at full width (male2female, random weights from
a seed), serving (A->B translation) and training (D and G steps at the D1/G2
cadence), through the hand-written CUDA kernels, and fails, with a non-zero
exit, if any phase fails:

1. device info (torch/CUDA versions, nvidia-smi name and power limit);
2. build every kernel under aclgan_tpu_torch/csrc with nvcc;
3. K1 (instance-norm forward) against its plain PyTorch version at the
   serving shapes, with timings of the kernel, the plain version and one
   library call over a Translator batch and over a D+G training iteration;
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
9. one JSON line listing every kernel;
10. last line: {"ok": true, "device": {...}}.

Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
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
        if e.device_type != DeviceType.CUDA:
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

    window = (imgs * 2)[:4 * BATCH]  # 4 full batches of requests
    win_styles = np.concatenate([styles, styles])[:4 * BATCH]
    for _ in range(2):
        tr(window, win_styles)
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr(window, win_styles)
        end.record()
        torch.cuda.synchronize()
        rates.append(len(window) / (start.elapsed_time(end) / 1e3))
    peak = torch.cuda.max_memory_allocated()
    log(f"[translator bf16] batch {BATCH}: p50 {np.median(rates):.1f} img/s over "
        f"7 windows of {len(window)} requests ({', '.join(f'{r:.1f}' for r in rates)}); "
        f"peak memory {peak / 2**30:.3f} GiB ({peak} B); vs f32: max {diff.max()} LSB, "
        f"mean {diff.mean():.4f} LSB")
    if diff.mean() > 8:
        raise AssertionError(f"bf16 outputs drift {diff.mean():.2f} LSB on average from f32")
    _profile(f"one window of {len(window)} requests", lambda: tr(window, win_styles))


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

    cfg = load_config(ROOT / "configs" / "male2female.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "gen_00000000.pt")
        save_generators(ckpt, ACLGAN(cfg, device="cuda", seed=0))
        outs32 = phase_translator_f32(cfg, ckpt)
        phase_translator_bf16(cfg, ckpt, outs32)
    torch.cuda.empty_cache()
    phase_train_f32(cfg)
    torch.cuda.empty_cache()
    k1["launches"], k2["launches"] = phase_train_bf16(cfg)

    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
