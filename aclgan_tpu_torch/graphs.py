"""CUDA graphs of the port's steps: what `jax.jit` does for the JAX package.

The JAX package compiles its train step (`aclgan_tpu/trainer.py:645-646`: one
executable per (do_dis, do_gen, step_increment) and shape; under a mesh
too, with the collectives XLA inserts), the display grid's `sample`
(`aclgan_tpu/cli/train.py:174`) and its served batch
(`aclgan_tpu/serving.py:124-128`: one per shape), and one host call then
launches each. `StepGraphs` gives the port the same on a CUDA device: a
step is recorded once per key into a `torch.cuda.CUDAGraph` and replayed, one
host call in place of the few thousand launches (98 K1 and 49 K2 among them
in a D+G iteration) that Python issues one at a time when eager. The train
step replays on one device and under an NCCL mesh of any size,
data-parallel or a spatial grid; gloo meshes keep it eager (`trainer.py`).

`run(key, inputs, body)`:

- The key's first call runs `body(*inputs)` eagerly on the graphs' side
  stream, as a real step: its updates count, and it brings into being what a
  capture must find (the kernels' lazily loaded modules, every launch variant
  the key uses, cuDNN's algorithm choice and the calling thread's cuDNN and
  cuBLAS handles, the optimizer's state, the gradients' buffers). A thread
  that has not run the key yet (a serving worker, say) runs it eagerly once
  too: its first cuDNN call allocates, which a capture refuses.
- The second call records `body` on static copies of its inputs into a
  graph, which executes nothing, and replays it at once. Capturing on the
  second call, not the first, puts the eager warm-ups of a step's keys (the
  D+G and the D-only iteration of the cadence's first two calls) before any
  graph holds memory: a warm-up after a capture would need the eager peak
  beside the graphs' pool (on an 80 GB H100, batch 64 under `remat: all`
  did not fit so).
- Every later call copies its inputs into those buffers and replays. Each
  replay returns copies of the static outputs: a value returned never
  changes under a later replay.

`body` takes and returns tensors (a tensor, or a tuple of tensors and Nones),
issues device work only (no read of a tensor on the host:
`tests/test_torch_graphs.py` holds the train step to that on the CPU), and
draws its random numbers from the `generators` given, which each graph
registers, so a replay draws what the eager step would have drawn, and a
reseed after the capture holds.

Collectives: a body may hold NCCL collectives (a train step under a mesh;
`mesh.capturable()`), which the graph records as device work.
The key's eager call creates their communicators (NCCL makes them at a
group's first collective, which a capture cannot do). Each rank records its
own graph, so every rank of the `mesh` given to `run` must capture the same
key at the same call: before the capture the ranks compare a digest of the
key, and after it whether every rank's capture succeeded (two small
all-reduces, outside the graph); a mismatch or a failure anywhere raises on
every rank, naming the key, rather than leaving a rank to replay
collectives that its peers never issue. A key run by one rank alone (the
display grid's `sample` on rank 0) is given no mesh. A graph holds its
collectives' communicators until it is destroyed, so each rank calls
`release` before its process group is destroyed (see there).

All graphs of one `StepGraphs` share one memory pool; `pool_bytes` is the
reserved memory their captures added, `capture_bytes` and `capture_seconds`
each key's share and capture time. A call holds the object's lock from its
copy-in to its copy-out (and across a capture), and its replay is ordered on
the device after the last one's, so threads may call one `StepGraphs` at once
(they share its static buffers) from any stream.
The kernels' launch counters (`ops/kernels/instance_norm.py`) count in their
Python wrappers, which a replay does not call: the change a capture made to
each is taken back and added at every replay instead. A capture that fails
raises with its key and cause; nothing falls back to the eager form. It
destroys its graph first, on every rank: the collectives the body recorded
before the failure hold their communicators as a finished graph's do, and
the exception would keep the graph alive through the caller's teardown.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Sequence, Set

import torch
import torch.distributed as dist

from aclgan_tpu_torch.ops.kernels import instance_norm as K


def _counts() -> List[int]:
    return [getattr(K, name) for name in K.COUNTERS]


def _set_counts(values: Sequence[int]) -> None:
    for name, v in zip(K.COUNTERS, values):
        setattr(K, name, v)


def _copy_out(out: Any) -> Any:
    if isinstance(out, torch.Tensor):
        return out.clone()
    return tuple(None if t is None else t.clone() for t in out)


class _Entry:
    """One key's graph, its static inputs and outputs, and its counters' change."""

    def __init__(self, graph, inputs: List[torch.Tensor], outputs: Any, delta: List[int]):
        self.graph, self.inputs, self.outputs, self.delta = graph, inputs, outputs, delta


class StepGraphs:
    """The captured steps of one model on one CUDA device, by key."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._warmed: Dict[Hashable, Set[int]] = {}  # the threads that ran each key eagerly
        self._entries: Dict[Hashable, _Entry] = {}
        self._pool = None
        self._stream = None
        self._lock = threading.Lock()
        self._done = None  # an event recorded after the last replay's copy-out
        self.pool_bytes = 0
        self.capture_bytes: Dict[Hashable, int] = {}
        self.capture_seconds: Dict[Hashable, float] = {}

    def keys(self) -> List[Hashable]:
        """Every key called so far: warmed (one call), or captured."""
        return list(self._warmed)

    def release(self) -> None:
        """Destroy every graph (`CUDAGraph.reset`), drop the static buffers,
        the warm set and the pool, and wait for the device. A graph whose
        body holds NCCL collectives keeps a reference on their communicator
        until it is destroyed, and NCCL's destroy of a communicator waits for
        every graph that references it: a graph left alive at
        `destroy_process_group` blocks it on every rank. Dropping the model
        does not destroy its graphs, since a model holds reference cycles
        that only Python's next collection frees, so every rank releases
        before its group goes (`ACLGAN.release_graphs`). `restore` and
        `init_state` release too: their graphs hold the replaced state's
        tensors and are never replayed again, and destroying them at once
        returns their pool to the allocator rather than at a collection. The
        object stays usable: the next call of a key is eager again."""
        for entry in self._entries.values():
            entry.graph.reset()
        self._warmed.clear()
        self._entries.clear()
        self._pool = None
        self.pool_bytes = 0
        self.capture_bytes.clear()
        self.capture_seconds.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, key: Hashable, inputs: Sequence[torch.Tensor], body: Callable[..., Any],
            generators: Sequence[torch.Generator] = (), mesh=None) -> Any:
        """body(*inputs): eager on the key's first call, captured on its
        second, replayed from then on. With a `mesh`, every rank of its
        `world_group` captures the key at the same call (see the module's
        docstring)."""
        with self._on_device(), self._lock:
            entry = self._entries.get(key)
            if entry is None:
                warmed = self._warmed.setdefault(key, set())
                if threading.get_ident() not in warmed:
                    with self._side():
                        out = body(*inputs)
                    warmed.add(threading.get_ident())
                    return out
                entry = self._entries[key] = self._capture(key, inputs, body, generators,
                                                           mesh)
            with self._in_order():
                for static, t in zip(entry.inputs, inputs):
                    static.copy_(t, non_blocking=True)
                entry.graph.replay()
                out = _copy_out(entry.outputs)
            _set_counts([c + d for c, d in zip(_counts(), entry.delta)])
            return out

    def _capture(self, key, inputs, body, generators, mesh) -> _Entry:
        if mesh is not None:
            digest = int.from_bytes(hashlib.sha256(repr(key).encode()).digest()[:7], "big")
            high, neg_low = self._all_max(mesh, [digest, -digest])
            if high != -neg_low:
                raise RuntimeError(f"CUDA graph capture of key {key!r}: the ranks of the mesh "
                                   f"capture different keys at this call")
        static = [t.clone() for t in inputs]
        graph = self._new_graph()
        for gen in generators:
            graph.register_generator_state(gen)
        reserved = self._free_cached()
        before = _counts()
        t0 = time.perf_counter()
        error = None
        try:
            with self._side():
                # thread_local: a serving worker captures while request
                # threads run (they issue no CUDA work)
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    out = body(*static)
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
        except Exception as e:
            error = e
        finally:
            after = _counts()
            _set_counts(before)  # the capture launched nothing
        failed_elsewhere = (mesh is not None
                            and self._all_max(mesh, [int(error is not None)])[0] > 0)
        if error is not None or failed_elsewhere:  # before the raise: see the docstring
            self._discard(graph)
        if error is not None:
            # out of memory stays that error, for callers that size batches by it:
            # the allocator's, or the CUDA runtime's when it instantiates the graph
            oom = isinstance(error, torch.cuda.OutOfMemoryError) or "out of memory" in str(error)
            kind = torch.cuda.OutOfMemoryError if oom else RuntimeError
            raise kind(f"CUDA graph capture failed for key {key!r}: "
                       f"{type(error).__name__}: {error}") from error
        if failed_elsewhere:
            raise RuntimeError(f"CUDA graph capture failed for key {key!r} on another rank "
                               f"of the mesh")
        self.capture_seconds[key] = time.perf_counter() - t0
        self.capture_bytes[key] = self._reserved() - reserved
        self.pool_bytes += self.capture_bytes[key]
        if self._pool is None:
            self._pool = graph.pool()
        return _Entry(graph, static, out, [a - b for a, b in zip(after, before)])

    def _all_max(self, mesh, values: List[int]) -> List[int]:
        """Each value's maximum over the mesh's ranks (eager, outside a graph)."""
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.world_group)
        return t.tolist()

    # the device's side of it (a stand-in replaces these on the CPU in the tests)
    def _new_graph(self):
        return torch.cuda.CUDAGraph()

    def _discard(self, graph) -> None:
        """Destroy a graph whose capture failed."""
        graph.reset()

    def _on_device(self):
        if self.device.index is None or self.device.index == torch.cuda.current_device():
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    @contextlib.contextmanager
    def _side(self):
        """Run on the side stream, ordered after and before the current one."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            yield
        current.wait_stream(self._stream)

    @contextlib.contextmanager
    def _in_order(self):
        """Order a replay after the last one on the device: a caller on
        another stream would otherwise refill the static inputs under it."""
        current = torch.cuda.current_stream(self.device)
        if self._done is None:
            self._done = torch.cuda.Event()
        else:
            current.wait_event(self._done)
        yield
        self._done.record(current)

    def _free_cached(self) -> int:
        """Release the allocator's cached blocks (the warm-up's) before a
        capture takes its own; returns the reserved bytes left."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return self._reserved()

    def _reserved(self) -> int:
        return torch.cuda.memory_reserved(self.device)
