#!/usr/bin/env python3
"""Memory of the port's train step as CUDA graphs against eager, on one GPU.

    python3 tools/torch_graphs.py rss [--out FILE]
    python3 tools/torch_graphs.py batch [--out FILE]
    python3 tools/torch_graphs.py spread [--readings N] [--out FILE]

`rss` and `batch` run the bare `ACLGAN.train_step` of
`configs/male2female.yaml` (bf16, 256^2, random weights and device-resident
uint8 batches from a seed, D1/G2), each form (`graphed`, `eager`) in a
process of its own, and print one JSON line a form and a last line that
sums them up. Import no JAX.

`spread`: phase 29's one-step bar of `chip_smoke.py` read N times (10 by
default) in one process, f32 with TF32 off: the graphed model trains
phase 29's six iterations (`chip_smoke.graph_cut`), then each reading is one
D+G iteration from its current state, replayed and eager in three copies
(`chip_smoke.one_step_spread`): the replayed state's rel-L2 from the first
eager copy, each eager pair's, and whether the replay stands within 2x
the first pair (the bar when two copies were read) and within 2x the
widest pair (phase 29's bar). Each reading starts from the state the last
replay left.

`rss`: host memory. ITERS iterations at batch BATCH, sampling the process's
VmRSS (`/proc/self/status`) before the first and every EVERY iterations: the
samples, s an iteration over each stretch between samples, and the
least-squares VmRSS slope in GiB an iteration from the first sample after
iteration 0 on (the first stretch holds the warm-up, the captures and the
allocator's growth).

`batch`: device memory. The largest batch (a multiple of 4) that trains
under `tpu.remat: all` and under `tpu.grad_accum: 4`: from batch 64 up,
doubling until one runs out of memory, then halving the gap down to 4. A
batch fits when six iterations (D+G, D, D+G, D, D+G, D: each key's eager
call, its capture, a replay) end without `torch.cuda.OutOfMemoryError` (or,
a limit that is not memory's, a tensor too large for 32-bit indexing: the
G step's decoder input at batch 128, twice the batch's rows). Each
try reports its peak allocated and reserved memory and, graphed, the pool
each capture added.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS, EVERY, BATCH = 3000, 500, 3
OPTIONS = {"remat_all": {"remat": "all"}, "grad_accum_4": {"grad_accum": 4}}
FIRST_BATCH = 64


def _rss_gib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("no VmRSS in /proc/self/status")


def _slope(points):
    """Least-squares slope of (iteration, GiB) points."""
    n = len(points)
    if n < 2:
        return None
    mx = sum(x for x, _ in points) / n
    my = sum(y for _, y in points) / n
    den = sum((x - mx) ** 2 for x, _ in points)
    return sum((x - mx) * (y - my) for x, y in points) / den


def _setup(option=None):
    import dataclasses

    import torch

    sys.path.insert(0, str(ROOT))
    from aclgan_tpu_torch.config import load_config

    if not torch.cuda.is_available():
        raise SystemExit("torch_graphs: no CUDA device available")
    cfg = load_config(ROOT / "configs" / "male2female.yaml")
    if option is not None:
        cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, **OPTIONS[option]))
    return cfg


def _batches(b, n):
    import numpy as np
    import torch

    rng = np.random.RandomState(1)
    return [tuple(torch.from_numpy(rng.randint(0, 256, (b, 256, 256, 3), dtype=np.uint8))
                  .cuda() for _ in range(2)) for _ in range(n)]


def run_rss(form: str) -> dict:
    import torch

    from aclgan_tpu_torch.trainer import ACLGAN

    cfg = _setup()
    cfg.batch_size = BATCH
    model = ACLGAN(cfg, device="cuda", graphs=form == "graphed")
    model.init_state()
    batches = _batches(BATCH, 4)
    samples = [(0, _rss_gib())]
    secs = []
    t0 = time.perf_counter()
    for it in range(ITERS):
        xa, xb = batches[it % len(batches)]
        model.train_step(xa, xb, it % cfg.D_update == 0, it % cfg.G_update == 0)
        if (it + 1) % EVERY == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            secs.append((t1 - t0) / EVERY)
            samples.append((it + 1, _rss_gib()))
            t0 = time.perf_counter()
    return {"form": form, "batch": BATCH, "iterations": ITERS,
            "device": torch.cuda.get_device_name(0),
            "rss_gib": [[i, round(g, 6)] for i, g in samples],
            "s_per_iteration": [round(s, 6) for s in secs],
            "slope_gib_per_iteration": _slope(samples[1:]),
            "graphs": None if model.graphs is None else len(model.graphs.keys())}


def _try_batch(cfg, form: str, b: int) -> dict:
    """Six D1/G2 iterations at batch b on a fresh model: its memory, or
    `oom` with the error's first line."""
    import gc

    import torch

    from aclgan_tpu_torch.trainer import ACLGAN

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = batches = None
    t0 = time.perf_counter()
    out = {"batch": b}
    try:
        batches = _batches(b, 2)
        model = ACLGAN(cfg, device="cuda", graphs=form == "graphed")
        model.init_state()
        for it in range(6):
            model.train_step(*batches[it % 2], True, it % 2 == 0)
        torch.cuda.synchronize()
        out["oom"] = None
    except torch.cuda.OutOfMemoryError as e:
        out["oom"] = str(e).splitlines()[0][:200]
    except RuntimeError as e:  # a tensor past int32 indexing: the step's limit, not memory's
        if "32-bit index math" not in str(e):
            raise
        out["oom"] = "not memory: " + str(e).splitlines()[0][:200]
    out.update(seconds=round(time.perf_counter() - t0, 3),
               peak_allocated=torch.cuda.max_memory_allocated(),
               peak_reserved=torch.cuda.max_memory_reserved())
    if model is not None and model.graphs is not None:
        out["pool"] = model.graphs.pool_bytes
        out["capture_bytes"] = {"D+G" if key[2] else "D": n
                                for key, n in model.graphs.capture_bytes.items()}
    del model, batches
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps(out), file=sys.stderr, flush=True)
    return out


def run_batch(form: str, option: str) -> dict:
    import torch

    cfg = _setup(option)
    tries = [_try_batch(cfg, form, FIRST_BATCH)]
    if tries[0]["oom"]:
        raise SystemExit(f"torch_graphs: {option} {form} does not fit batch {FIRST_BATCH}")
    lo, hi = FIRST_BATCH, None
    while hi is None:
        tries.append(_try_batch(cfg, form, 2 * lo))
        if tries[-1]["oom"]:
            hi = 2 * lo
        else:
            lo = 2 * lo
    while hi - lo > 4:
        mid = (lo + hi) // 8 * 4
        tries.append(_try_batch(cfg, form, mid))
        if tries[-1]["oom"]:
            hi = mid
        else:
            lo = mid
    free, total = torch.cuda.mem_get_info()
    largest = next(t for t in tries if t["batch"] == lo)
    return {"form": form, "option": option, "largest_batch": lo, "first_oom_batch": hi,
            "at_largest": largest, "device": torch.cuda.get_device_name(0),
            "device_bytes": total, "tries": tries}


def run_spread(readings: int) -> dict:
    import torch

    cfg = _setup()
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cut, batches = chip_smoke.graph_cut(cfg)
    model = chip_smoke._graph_train_run(cut, True, batches)[0]
    rows = []
    for i in range(readings):
        _, _, replayed, pairs = chip_smoke.one_step_spread(cut, model, batches[-1])
        rows.append({"reading": i, "replayed": replayed, "eager_pairs": pairs,
                     "within_2x_first_pair": replayed <= 2 * pairs[0],
                     "within_2x_widest_pair": replayed <= 2 * max(pairs)})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return {"device": torch.cuda.get_device_name(0), "readings": rows,
            "missed_first_pair_bar": sum(not r["within_2x_first_pair"] for r in rows),
            "missed_widest_pair_bar": sum(not r["within_2x_widest_pair"] for r in rows)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("rss", "batch", "spread"))
    ap.add_argument("--readings", type=int, default=10, help="spread: readings to take")
    ap.add_argument("--form", choices=("graphed", "eager"), default=None,
                    help="run one form in this process")
    ap.add_argument("--option", choices=tuple(OPTIONS), default=None,
                    help="batch: the option of that form's search")
    ap.add_argument("--out", type=str, default=None, help="also write the results here")
    args = ap.parse_args(argv)
    if args.what == "spread":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        print(smi, flush=True)
        result = dict(run_spread(args.readings), card=smi)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1))
        print(json.dumps({k: result[k] for k in ("missed_first_pair_bar",
                                                 "missed_widest_pair_bar")}), flush=True)
        return 0
    if args.form is not None:
        result = (run_rss(args.form) if args.what == "rss"
                  else run_batch(args.form, args.option))
        print(json.dumps(result), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    runs = ([["--form", f] for f in ("graphed", "eager")] if args.what == "rss" else
            [["--form", f, "--option", o] for o in OPTIONS for f in ("graphed", "eager")])
    results = []
    for extra in runs:
        out = subprocess.run([sys.executable, __file__, args.what, *extra],
                             capture_output=True, text=True, cwd=ROOT, env=dict(os.environ))
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    summary = {"card": smi, "what": args.what, "forms": results}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    if args.what == "rss":
        print(json.dumps({r["form"]: r["slope_gib_per_iteration"] for r in results}),
              flush=True)
    else:
        print(json.dumps({f"{r['option']} {r['form']}": r["largest_batch"] for r in results}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
