#!/usr/bin/env python3
"""K1 and K2, the unsharded instance-norm kernels, timed alone on one NVIDIA
GPU: each layer of `chip_smoke.py`'s mixes (a bf16 Translator batch of 32
and a D+G iteration at batch 16 for K1, a G step at batch 16 for K2) by CUDA
events and by device time a launch (torch.profiler, or CUDA events behind a
queued busy kernel where it loses the kernels), beside the bound and the
library call (`F.instance_norm`; `native_batch_norm_backward` given the
statistics), with each layer's launch plan. Where the kernels have two
variants, the streaming one is timed too at every layer.

    python3 tools/torch_fused_kernels.py [--root DIR]

`--root` takes `aclgan_tpu_torch` from another checkout (for example a parent
commit unpacked with `git archive` into a directory that `.gitignore` lists),
so that two versions of the kernels can be timed on one card in one run, in
turns; a K2 that recomputes the statistics (`instance_norm_bwd(x, scale, y,
dy, eps, activ)`) is called so. The timing code is this checkout's
`chip_smoke.py`. Prints its `[kernel]` lines, the card's name and power
limit, and one JSON line. Exits 2 without a CUDA device. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose aclgan_tpu_torch is measured (default: this one)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fused_kernels: no CUDA device available", flush=True)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = _chip_smoke()
    import aclgan_tpu_torch
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cs.log(f"[fused] aclgan_tpu_torch from {Path(aclgan_tpu_torch.__file__).parent}; "
           f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")
    cs.phase_build()
    saved = "mean" in inspect.signature(K.instance_norm_bwd).parameters
    planned = hasattr(K, "_fused_plan")
    g = torch.Generator(device="cuda").manual_seed(0)

    def plan_of(x, inputs):
        if not planned:
            return None
        n, c, h, w = x.shape
        return K._fused_plan(n * c, h * w, x.element_size(), K._align(x.data_ptr()), inputs)

    def fwd_make(shape, affine):
        n, c, h, w = shape
        x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        s = torch.randn(n, c, device="cuda", generator=g) if affine else None
        b = torch.randn(n, c, device="cuda", generator=g) if affine else None
        return x, s, b, x.view(1, n * c, h, w), None if s is None else s.flatten(), \
            None if b is None else b.flatten()

    def bwd_make(shape, affine):
        n, c, h, w = shape
        x, s, b, xv, wv, bv = fwd_make(shape, affine)
        dy = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        if saved:
            y, mean, rsig = K._launch(x, s, b, 1e-5, "relu", stats=True)
        else:
            y, (mean, rsig) = K.fused_instance_norm(x, s, b, activ="relu"), (None, None)
        _, lmean, invstd = torch.ops.aten.native_batch_norm(xv, wv, bv, None, None, True,
                                                            0.0, 1e-5)
        return x, s, y, dy, mean, rsig, xv, dy.view(1, n * c, h, w), wv, lmean, invstd, \
            [True, affine, affine]

    kernels = {
        "instance_norm_fwd": dict(
            make=fwd_make, inputs=1, flops=10.0,
            run=lambda x, s, b, *_: K.fused_instance_norm(x, s, b, activ="relu"),
            streaming=lambda x, s, b, *_: K._launch(
                x, s, b, 1e-5, "relu", plan=(1, plan_of(x, 1)[1], False)),
            plain=lambda x, s, b, *_: K.instance_norm_plain(x, s, b, activ="relu"),
            library=lambda x, s, b, xv, wv, bv: F.instance_norm(xv, weight=wv, bias=bv,
                                                                eps=1e-5),
            nbytes=lambda shape, affine: 4 * math.prod(shape)
            + (8 * shape[0] * shape[1] if affine else 0),
            mixes={f"bf16 Translator batch of {cs.BATCH}":
                   cs._encode_mix(cs.BATCH) + cs._decode_mix(cs.BATCH),
                   f"bf16 D+G iteration at batch {cs.TRAIN_BATCH}":
                   cs._d_step_mix(cs.TRAIN_BATCH) + cs._g_step_mix(cs.TRAIN_BATCH)}),
        "instance_norm_bwd": dict(
            make=bwd_make, inputs=3, flops=20.0,
            run=(lambda x, s, y, dy, mean, rsig, *_: K.instance_norm_bwd(
                x, s, y, dy, mean, rsig, "relu")) if saved else
            (lambda x, s, y, dy, *_: K.instance_norm_bwd(x, s, y, dy, 1e-5, "relu")),
            streaming=lambda x, s, y, dy, mean, rsig, *_: K.instance_norm_bwd(
                x, s, y, dy, mean, rsig, "relu", plan=(1, plan_of(x, 3)[1], False)),
            plain=lambda x, s, y, dy, *_: K.instance_norm_bwd_plain(x, s, y, dy, 1e-5, "relu"),
            library=lambda *a: torch.ops.aten.native_batch_norm_backward(
                a[7], a[6], a[8], None, None, a[9], a[10], True, 1e-5, a[11]),
            nbytes=lambda shape, affine: 8 * math.prod(shape)
            + (20 if affine else 8) * shape[0] * shape[1],
            mixes={f"bf16 G step at batch {cs.TRAIN_BATCH}": cs._g_step_mix(cs.TRAIN_BATCH)})}

    entries = []
    for name, k in kernels.items():
        extra = {"streaming": k["streaming"]} if planned else None

        def describe(x, *_, inputs=k["inputs"]):
            plan = plan_of(x, inputs)
            return "no plan (one CTA a row)" if plan is None else cs._plan_label(plan)

        for work, mix in k["mixes"].items():
            tot = cs._time_mix(name, mix, k["make"], k["run"], k["plain"],
                               k["library"], k["nbytes"], k["flops"], extra=extra,
                               describe=describe)
            cs._log_total(name, work, tot)
            dev = cs._fused_device(name, mix, k["make"], k["run"], k["library"],
                                   name, k["nbytes"], tot, work)
            entries.append(dict(name=name, work=work, **tot, **dev))
    print(json.dumps({"root": str(root), "card": smi, "kernels": entries}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
