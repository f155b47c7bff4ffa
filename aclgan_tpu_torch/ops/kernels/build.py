"""Build the CUDA sources under `aclgan_tpu_torch/csrc/` and load them.

Each `.cu` file has a plain C interface and is compiled by `nvcc` into its own
shared library, loaded with `ctypes`. Libraries go to
`aclgan_tpu_torch/_build/`, named by a hash of every file under `csrc/` and
the flags, so an edited source rebuilds and an unchanged one is reused.
Nothing is built at import: the first launch builds what it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin "
                       "(needed to build the CUDA kernels)")


def library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: Iterable[str]) -> Dict[str, str]:
    """Compile every source that has no up-to-date library, one `nvcc` per
    source, all started together. Returns each compiled source's compiler
    output (ptxas register and shared-memory report); raises with nvcc's
    stderr if one fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[src] = (tmp, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for src, (tmp, out, proc) in procs.items():
        logs[src] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed for {src}:\n{logs[src]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        build_all([source])
        lib = _loaded[source] = ctypes.CDLL(str(library_path(source)))
    return lib
