#!/usr/bin/env python3
"""The train CLI's host memory over a run: VmRSS of the CLI's process,
sampled at each `Iteration:` line and every `--poll` seconds.

    python3 tools/torch_cli_rss.py --config C --work DIR --iters N
        [--device cuda|cpu] [--set KEY=VALUE ...] [--cli port|jax]
        [--label NAME] [--poll S]

The CLI runs in a child process (`python -m aclgan_tpu_torch.cli.train`, or
with `--cli jax` the JAX package's `aclgan_tpu.cli.train`, unmodified, on the
CPU) on a copy of C in DIR with each `--set` applied (`KEY` a top-level key,
a data key such as `num_workers` or `synthetic`, or `gen.dim`,
`tpu.ema_decay`, ...). Writes DIR/NAME.json: the samples (seconds,
iteration, VmRSS bytes), VmRSS at iteration 500 and at the end, and the
least-squares slope after iteration 500 (GiB per 1,000 iterations). This
script imports nothing of JAX or of `aclgan_tpu` (the port's config reader
writes the copy); the CLI's own process imports its package.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from aclgan_tpu_torch.utils.hostmem import RssSampler, rss_slope  # noqa: E402

ITERATION = re.compile(r"^Iteration: (\d+)/\d+ \(([0-9.]+)s\)$")
FROM = 500  # the slope and growth are read from this iteration on


def _value(text: str):
    """A `--set` value as the YAML reader would take it."""
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def write_config(src: Path, sets: List[str], out: Path) -> None:
    """`src` with each KEY=VALUE of `sets` applied, written to `out` in the
    YAML subset both packages read."""
    import dataclasses

    from aclgan_tpu_torch.config import load_config, save_config

    cfg = load_config(src)
    for item in sets:
        key, _, text = item.partition("=")
        section, _, name = key.rpartition(".")
        if not section and hasattr(cfg.data, name) and not hasattr(cfg, name):
            section = "data"
        if section:
            part = getattr(cfg, section)
            if not hasattr(part, name):
                raise SystemExit(f"--set {item}: no key {name!r} in {section}")
            cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
                part, **{name: _value(text)})})
        elif hasattr(cfg, name):
            cfg = dataclasses.replace(cfg, **{name: _value(text)})
        else:
            raise SystemExit(f"--set {item}: no key {name!r}")
    save_config(cfg, out)


def summarize(samples: List[tuple], start: int = FROM) -> Dict:
    """VmRSS at `start` and at the end, the growth between and the slope
    after `start`."""
    at = next((s for s in samples if s[1] >= start), None)
    end = samples[-1] if samples else None
    gib = (lambda b: None if b is None else round(b / 2**30, 4))
    growth = None if at is None or end is None else end[2] - at[2]
    slope = rss_slope([(s[1], s[2]) for s in samples], start)
    return {"rss_gib_first": gib(samples[0][2]) if samples else None,
            f"rss_gib_at_{start}": gib(at and at[2]), "rss_gib_end": gib(end and end[2]),
            "rss_gib_max": gib(max(s[2] for s in samples)) if samples else None,
            f"growth_gib_after_{start}": gib(growth),
            "slope_gib_per_1000": None if slope is None else round(slope, 5),
            "iterations": end[1] if end else None}


def run(args) -> Dict:
    work = Path(args.work).resolve()
    work.mkdir(parents=True, exist_ok=True)
    cfg = work / f"{args.label}.yaml"
    write_config(Path(args.config), args.set, cfg)
    out_dir = work / args.label
    cli = ["--config", str(cfg), "--output_path", str(out_dir), "--max_iter", str(args.iters)]
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    if args.cli == "jax":
        env.setdefault("JAX_PLATFORMS", "cpu")
        cmd = [sys.executable, "-m", "aclgan_tpu.cli.train", *cli]
    else:
        cmd = [sys.executable, "-m", "aclgan_tpu_torch.cli.train", *cli, "--device", args.device]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)
    tail: List[str] = []
    with RssSampler(proc.pid, every=args.poll) as sampler:
        for line in proc.stdout:
            line = line.rstrip("\n")
            tail = (tail + [line])[-40:]
            m = ITERATION.match(line)
            if m:
                sampler.iteration = int(m[1])
                sampler.sample()
                if sampler.iteration % args.print_every == 0:
                    print(f"[{args.label}] {line}  VmRSS {sampler.rss[-1][2] / 2**30:.4f} GiB",
                          flush=True)
        rc = proc.wait()
    samples = sampler.rss
    doc = {"label": args.label, "cli": args.cli, "device": args.device,
           "config": str(args.config), "set": args.set, "iters": args.iters, "rc": rc,
           "seconds": round(time.time() - t0, 1), "summary": summarize(samples),
           "samples": samples}
    if rc:
        doc["tail"] = tail
    out = Path(args.out) if args.out else work / f"{args.label}.json"
    out.write_text(json.dumps(doc))
    print(f"[{args.label}] rc {rc} {doc['seconds']} s " + json.dumps(doc["summary"]),
          flush=True)
    if rc:
        print("\n".join(tail), flush=True)
    return doc


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--work", required=True, help="where the config copy and outputs go")
    ap.add_argument("--iters", type=int, required=True)
    ap.add_argument("--device", default="cuda", help="cuda or cpu (the port's CLI)")
    ap.add_argument("--set", action="append", default=[], help="KEY=VALUE, repeatable")
    ap.add_argument("--cli", choices=("port", "jax"), default="port")
    ap.add_argument("--label", default="run")
    ap.add_argument("--poll", type=float, default=5.0, help="seconds between samples")
    ap.add_argument("--print_every", type=int, default=500)
    ap.add_argument("--out", default=None, help="the JSON (default DIR/LABEL.json)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
