"""Data parallelism: one process a GPU, joined by `torch.distributed`.

Port of `aclgan_tpu/parallel/mesh.py`. Where the JAX package lays a 1-D
`Mesh(('data',))` over its devices and lets XLA compile the gradient
all-reduce from the shardings, the port runs one process a device (launched
by `torchrun`) and does the exchange itself:

- `init_distributed` joins the process group from torchrun's environment
  (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`): NCCL
  on `cuda:LOCAL_RANK`, gloo on the CPU;
- `make_mesh` is the data-parallel group, `DataMesh` (every process, in rank
  order); `batch_sharding` this rank's rows of a global batch;
- `replicate` / `shard_state` broadcast rank 0's parameters, buffers and
  moments, so that every rank starts from the same state;
- `all_reduce_sum` is a differentiable all-reduce (its backward all-reduces
  the gradient), through which bn's batch statistics and the focus loss's
  batch sums become those of the global batch; `all_reduce_mean` averages
  gradients and metrics; `coordination_barrier` is `dist.barrier`.

Only `all_reduce`, `broadcast` and `barrier` are used: they work with NCCL,
with gloo on the CPU and with gloo on CUDA tensors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

TORCHRUN_HINT = ("launch one process a GPU with `torchrun --nproc_per_node N -m "
                 "aclgan_tpu_torch.cli.train` and set `tpu.distributed: true`")


@dataclass(frozen=True)
class DataMesh:
    """The data-parallel group: every process of the default group."""

    rank: int
    world: int


def init_distributed(device_type: str) -> torch.device:
    """Join the process group from torchrun's environment, once; returns this
    process's device (`cuda:LOCAL_RANK`, or the CPU)."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"tpu.distributed: true needs torchrun's environment "
                           f"({', '.join(missing)} unset); {TORCHRUN_HINT}")
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return device


def make_mesh(n_data: int = -1) -> Optional[DataMesh]:
    """The data-parallel group of `n_data` processes (-1: every process), or
    None in a single process that joined no group. `tpu.mesh_data` larger
    than the world raises as the JAX package does; a single process asked
    for more than one device raises naming torchrun."""
    if not dist.is_initialized():
        if n_data > 1:
            raise ValueError(f"tpu.mesh_data={n_data} in a single process: the port runs "
                             f"one process a GPU; {TORCHRUN_HINT}")
        return None
    world = dist.get_world_size()
    n = world if n_data == -1 else n_data
    if n > world:
        raise ValueError(f"mesh_data={n} > available devices {world}")
    if n != world:
        raise ValueError(f"mesh_data={n} < {world} processes: every process of the "
                         f"group trains in the data-parallel mesh (set -1 or {world})")
    return DataMesh(dist.get_rank(), world)


def batch_sharding(mesh: Optional[DataMesh], batch: int) -> slice:
    """This rank's rows of a global batch of `batch` rows (rank order)."""
    if mesh is None:
        return slice(0, batch)
    if batch % mesh.world:
        raise ValueError(f"batch {batch} not divisible by {mesh.world} processes")
    n = batch // mesh.world
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def replicate(tensors: Iterable[torch.Tensor], mesh: Optional[DataMesh]) -> None:
    """Overwrite `tensors` in place with rank 0's values: one broadcast per
    (device, dtype) bucket of a flat copy."""
    if mesh is None:
        return
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    with torch.no_grad():
        for group in buckets.values():
            flat = _flatten_dense_tensors([t.detach() for t in group])
            dist.broadcast(flat, 0)
            for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(v)


def shard_state(model, mesh: Optional[DataMesh]) -> None:
    """Training state is replicated under data parallelism: broadcast every
    parameter and buffer of the five networks, the EMA copies and both
    optimizers' moments from rank 0. The optimizers' step counts (host
    scalars) and the z generator are equal on every rank by construction:
    seeded alike, or read from the same snapshot."""
    if mesh is None:
        return
    replicate(_state_tensors(model), mesh)


def _state_tensors(model) -> List[torch.Tensor]:
    from aclgan_tpu_torch.trainer import DIS_NAMES, GEN_NAMES

    nets = [model.gen(n) for n in GEN_NAMES] + [model.dis(n) for n in DIS_NAMES]
    out = [t for net in nets for t in list(net.parameters()) + list(net.buffers())]
    if model.ema is not None:
        out += [t for n in GEN_NAMES for t in model.ema[n].values()]
    for opt in (model.gen_opt, model.dis_opt):
        out += [v for state in opt.state.values() for v in state.values()
                if isinstance(v, torch.Tensor) and v.device == model.device]
    return out


def all_reduce_mean(tensors: List[torch.Tensor], mesh: DataMesh) -> None:
    """Replace each tensor in place by its mean over the ranks: one
    all-reduce of a flat copy."""
    if not tensors:
        return
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat)
    flat.div_(mesh.world)
    for t, v in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(v)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks. Every rank's y feeds the same loss, so
    the gradient of x is the sum of y's gradients over the ranks."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable."""
    return _AllReduceSum.apply(x)


def coordination_barrier(name: str = "") -> None:
    """Wait for every process (no-op in a single process). `name` labels the
    call site, as in the JAX package."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
