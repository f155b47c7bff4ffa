#!/usr/bin/env python3
"""The split instance-norm kernels' part of `chip_smoke.py` phase 27 alone,
on one NVIDIA GPU: K1m, K1a, K2m and K2a against their plain versions (the
phase-27 shapes, the odd layouts, two launches bit-equal), K1m's and K2m's
host microseconds a call, then each kernel timed over one rank's iteration
(CUDA events, and device time a launch from torch.profiler) beside its bound
and its library call.

    python3 tools/torch_split_kernels.py [--root DIR]

`--root` takes `aclgan_tpu_torch` from another checkout (for example a parent
commit unpacked with `git archive` into a directory that `.gitignore` lists),
so that two versions of the kernels can be timed on one card in one run, in
turns. Prints the `[kernel]` lines, the card's name and power limit, and the
kernels' entries as one JSON line.
Exits 2 without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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
    print(json.dumps({"root": str(root), "card": smi, "kernels": entries}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
