#!/usr/bin/env python3
"""The split instance-norm kernels' part of `chip_smoke.py` phase 27 alone,
on one NVIDIA GPU: K1m, K1a, K2m and K2a against their plain versions (the
phase-27 shapes, the odd layouts, two launches bit-equal), each kernel's
host microseconds a call, the sharded forward's chain without its
collective, then each kernel timed over one rank's iteration (CUDA events,
and device time a launch from torch.profiler) beside its bound and its
library call.

    python3 tools/torch_split_kernels.py [--root DIR]

`--root` takes `aclgan_tpu_torch` from another checkout (for example a parent
commit unpacked with `git archive` into a directory that `.gitignore` lists),
so that two versions of the kernels can be timed on one card in one run, in
turns. Where that checkout's K1a still takes (mean, rsig) rather than the
moments, its phase 27 measured no host cost for K1a and K2a and no forward
chain; this script then measures them with that API (`_older_api`). Prints
the `[kernel]` lines, the card's name and power limit, and the kernels'
entries as one JSON line.
Exits 2 without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose aclgan_tpu_torch is measured (default: this one)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_split_kernels: no CUDA device available", flush=True)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(REPO)]
    import chip_smoke
    import aclgan_tpu_torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    chip_smoke.log(f"[split] aclgan_tpu_torch from {Path(aclgan_tpu_torch.__file__).parent}; "
                   f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")
    chip_smoke.phase_build()
    entries = chip_smoke._split_kernels((None,) * len(chip_smoke.SPLIT_KERNELS))
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    if "moments" not in inspect.signature(K.instance_norm_apply).parameters:
        _older_api(chip_smoke, K, {e["name"]: e for e in entries})
    print(json.dumps({"root": str(root), "card": smi, "kernels": entries}), flush=True)
    return 0


def _older_api(chip_smoke, K, entries):
    """For a K1a that takes (mean, rsig): K1a's and K2a's host microseconds a
    call against eval `F.batch_norm` and `native_batch_norm_backward`'s input
    gradient (1x1x8x8 bf16, 5000 calls, in turns, as the current
    `_split_host_cost`), into their entries; and the sharded forward's chain
    without its collective (K1m, `_stats`, K1a) over one rank's D+G iteration
    of phase 27 by CUDA events, logged."""
    F = torch.nn.functional
    x = torch.randn(1, 1, 8, 8, device="cuda").to(torch.bfloat16)
    y, dy = torch.relu(x), torch.randn_like(x)
    mean, rsig = torch.zeros(1, 1, device="cuda"), torch.ones(1, 1, device="cuda")
    sums = torch.zeros(1, 1, 2, device="cuda")
    ones, mean1, rsig1 = torch.ones(1, device="cuda"), mean.flatten(), rsig.flatten()
    calls = {
        "K1a": lambda: K.instance_norm_apply(x, mean, rsig, None, None, "relu"),
        "F.batch_norm": lambda: F.batch_norm(x, mean1, rsig1, None, None, False, 0.0, 1e-5),
        "K2a": lambda: K.instance_norm_bwd_apply(x, y, dy, mean, rsig, None, sums, 64, "relu"),
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
    chip_smoke.log("[split] older API: host cost a call (1x1x8x8 bf16, 5000 calls, in turns): "
                   + "; ".join(f"{k} {', '.join(f'{u:.2f}' for u in v)} us"
                               for k, v in us.items()))
    for name, kernel, library in (("instance_norm_apply", "K1a", "F.batch_norm"),
                                  ("instance_norm_bwd_apply", "K2a",
                                   "native_batch_norm_backward dx")):
        entries[name].update(host_us=sum(us[kernel]) / len(us[kernel]),
                             library_host_us=sum(us[library]) / len(us[library]))
    world = chip_smoke.SP_WORLD
    mix = chip_smoke._d_step_mix(chip_smoke.SP_BATCH, chip_smoke.SP_ROWS, chip_smoke.SP_SIZE) + \
        chip_smoke._g_step_mix(chip_smoke.SP_BATCH, chip_smoke.SP_ROWS, chip_smoke.SP_SIZE)
    g = torch.Generator(device="cuda").manual_seed(2)
    chain_ms = stats_ms = 0.0
    for (n, c, h, w), affine, count in mix:
        xs = torch.randn(n, c, h, w, device="cuda", generator=g).to(torch.bfloat16)
        s = torch.randn(n, c, device="cuda", generator=g) if affine else None
        b = torch.randn(n, c, device="cuda", generator=g) if affine else None
        m = K.row_moments_plain(xs) * world

        def chain():
            st = K._stats(K.instance_norm_row_moments(xs), h * w * world, 1e-5)
            return K.instance_norm_apply(xs, *st, s, b, "relu")

        chain_ms += count * chip_smoke.time_ms(chain)
        stats_ms += count * chip_smoke.time_ms(lambda: K._stats(m, h * w * world, 1e-5))
        del xs
    chip_smoke.log(f"[split] older API: forward chain without the all-reduce, K1m, `_stats`, "
                   f"K1a, over one rank's D+G iteration of phase 27 (bf16, CUDA events): "
                   f"{chain_ms:.4f} ms; `_stats` alone {stats_ms:.4f} ms")


if __name__ == "__main__":
    sys.exit(main())
