"""Host memory of a training process: VmRSS read from /proc, a sampler of it
over a run, the least-squares slope of the samples, and the hand-back of the
C heap's free pages to the OS."""

from __future__ import annotations

import ctypes
import threading
import time
from typing import List, Optional, Tuple, Union

_MALLOC_TRIM = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc's; absent elsewhere


def release_host_heap() -> bool:
    """Hand the host heap's free pages back to the OS (glibc `malloc_trim`);
    False where the C library has no such call.

    A snapshot's and a grid's host copies are large and short-lived. Once a
    snapshot's frees have raised glibc's dynamic mmap threshold, later
    copies of that size come from the heap instead of their own mappings,
    and the small allocations made in between keep the freed heap pages
    resident: without this, VmRSS rose in a step at the first grid after a
    snapshot and a little at each later one."""
    if _MALLOC_TRIM is None:
        return False
    _MALLOC_TRIM(0)
    return True


def vmrss(pid: Union[int, str] = "self") -> Optional[int]:
    """VmRSS of process `pid` in bytes; None where /proc has no such process
    (or it has exited: a zombie reads 0)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 or None
    except OSError:
        pass
    return None


def rss_slope(points: List[Tuple[int, int]], start: int) -> Optional[float]:
    """Least-squares slope of (iteration, VmRSS bytes) points at iteration
    `start` and later, in GiB per 1,000 iterations (None with fewer than two
    iterations)."""
    pts = [(it, rss) for it, rss in points if it >= start]
    if len({it for it, _ in pts}) < 2:
        return None
    n = len(pts)
    mx = sum(it for it, _ in pts) / n
    my = sum(r for _, r in pts) / n
    sxx = sum((it - mx) ** 2 for it, _ in pts)
    sxy = sum((it - mx) * (r - my) for it, r in pts)
    return sxy / sxx * 1000 / 2**30


class RssSampler:
    """VmRSS of process `pid` as (seconds since the start, iteration, bytes)
    rows in `rss`: at each `sample()` and every `every` seconds from a
    thread, while the sampler is entered. The caller keeps `iteration`."""

    def __init__(self, pid: Union[int, str] = "self", every: float = 30.0, start: int = 0):
        self.pid, self.iteration = pid, start
        self.t0 = time.time()
        self.rss: List[Tuple[float, int, int]] = []
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._poll, args=(every,), daemon=True)

    def sample(self) -> None:
        r = vmrss(self.pid)
        if r is not None:
            with self.lock:
                self.rss.append((round(time.time() - self.t0, 3), self.iteration, r))

    def _poll(self, every: float) -> None:
        while not self.stop.wait(every):
            self.sample()

    def __enter__(self):
        self.sample()
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.sample()
