"""Processes of the port's data-parallel tests (not a test module). Spawned
ranks import this module and nothing of JAX: they join a gloo group on the
CPU (or, in the CUDA tests, an NCCL group of one rank a card) over localhost
and hand their results back through files.

Every spawn runs under one deadline (`torch_ranks.spawn`)."""

import contextlib
import os
import time

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import Work
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from torch_ranks import (free_port, group_timeout, init_rank,  # noqa: F401 (the tests' names)
                         mesh_graph_steps, spawn, teardown)


def _join(rank, world, port):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world, timeout=group_timeout())


def hang_one_rank(rank, world, port, seconds):
    """One all-reduce on every rank, then rank 1 sleeps `seconds` while the
    others wait for it in a second all-reduce: a hung rank, for the deadline."""
    _join(rank, world, port)
    try:
        t = torch.ones(4)
        dist.all_reduce(t)
        if rank == 1:
            _sleep_past_the_deadline(seconds)
        dist.all_reduce(t)
    finally:
        teardown()


def _sleep_past_the_deadline(seconds):
    time.sleep(seconds)


def dp_steps(rank, world, port, cases, out_dir, device_type="cpu"):
    """For each case (name, config dict, snapshot path, global x_a, x_b, z),
    one D+G iteration on this rank's rows; saves the metrics and the state
    of the five networks to out_dir/<name>.<rank>.pt. With device_type
    "cuda" the rank runs on card `rank` over NCCL, with TF32 off."""
    from aclgan_tpu_torch.config import from_dict
    from aclgan_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_state
    from aclgan_tpu_torch.trainer import ACLGAN

    device = init_rank(rank, world, port, device_type)
    models = []
    try:
        mesh = make_mesh(-1)
        for name, cfg_dict, snap_path, x_a, x_b, z in cases:
            model = ACLGAN(from_dict(cfg_dict), device=device, mesh=mesh)
            models.append(model)
            model.init_state()
            model.restore(torch.load(snap_path, map_location="cpu", weights_only=True))
            shard_state(model, mesh)
            rows = batch_sharding(mesh, x_a.shape[0])
            metrics = model.train_step(x_a[rows], x_b[rows], True, True, z=z)
            snap = model.snapshot()
            torch.save({"metrics": metrics, "gen": snap["gen"], "dis": snap["dis"]},
                       os.path.join(out_dir, f"{name}.{rank}.pt"))
    finally:
        teardown(models)


def cli_run(rank, world, port, argv, resume_argv, port2, out_dir):
    """The train CLI as torchrun would start rank `rank`: `argv`, then
    `resume_argv` on a second rendezvous port; saves what each run left
    (display batches, the networks, the EMA, the G moments, the step)."""
    from aclgan_tpu_torch.cli.train import main

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1")
    for tag, args, p in (("first", argv, port), ("resumed", resume_argv, port2)):
        os.environ["MASTER_PORT"] = str(p)
        run = main(args)
        assert not dist.is_initialized()  # the CLI leaves the group it joined
        snap = run.model.snapshot()
        torch.save({"displays": run.displays, "gen": snap["gen"], "dis": snap["dis"],
                    "ema": snap["ema"], "gen_opt": snap["gen_opt"],
                    "step": snap["step"], "iterations": run.iterations},
                   os.path.join(out_dir, f"{tag}.{rank}.pt"))


HALO_FORMS = {"point_to_point": True, "all_reduce": False}  # form: `_point_to_point`'s answer


def halo_ops(rank, world, port, x, g, convs, gamma, beta, scale, shift, out_dir):
    """The spatial ops on this rank's H-slice of the NCHW `x` (H split over all
    `world` ranks of a 1 x world grid): `halo_conv` for each entry of `convs`
    ({name: (weight, bias, stride, padding, pad_type, H)}, on x's first H
    rows), the sharded IN, LN,
    pools, the gradient of `halo_rows` against the cotangent `g` of its
    output, and the split AdaIN (`fused_instance_norm` under the mesh) with
    its gradients; saves them to out_dir/halo.<rank>.pt. The ops that move
    halo rows run in each form of `HALO_FORMS` (the all-reduce form forced
    on the CPU), under keys "<form>:<op>"."""
    from aclgan_tpu_torch.ops import norms, pool
    from aclgan_tpu_torch.ops.kernels.instance_norm import fused_instance_norm
    from aclgan_tpu_torch.parallel import halo
    from aclgan_tpu_torch.parallel.spatial import make_mesh_2d

    _join(rank, world, port)
    chooser = halo._point_to_point
    try:
        mesh = make_mesh_2d(1, world)
        h = x.shape[2] // world
        xl = x[:, :, rank * h:(rank + 1) * h].contiguous()
        out = {}
        for form, p2p in HALO_FORMS.items():
            halo._point_to_point = lambda t, group, p2p=p2p: p2p and chooser(t, group)
            for name, (w, b, stride, padding, pad_type, rows) in convs.items():
                hc = rows // world
                out[f"{form}:{name}"] = halo.halo_conv(
                    x[:, :, rank * hc:(rank + 1) * hc].contiguous(), w, b, mesh, stride,
                    padding, pad_type)
            out[f"{form}:pool"] = pool.avg_pool_3x3_s2(xl, mesh)
            for pad_type, (top, bottom, gl) in g.items():
                xg = xl.clone().requires_grad_()
                gr = gl[:, :, rank * h:rank * h + h + top + bottom]
                (halo.halo_rows(xg, top, bottom, mesh, pad_type) * gr).sum().backward()
                out[f"{form}:halo_grad_{pad_type}"] = xg.grad
        halo._point_to_point = chooser
        out["in"] = halo.sharded_instance_norm(xl, mesh)
        out["ln"] = norms.sample_layer_norm(xl, gamma, beta, mesh=mesh)
        out["gap"] = pool.global_avg_pool(xl, mesh)
        xg, sg, bg = (t.clone().requires_grad_() for t in (xl, scale, shift))
        y = fused_instance_norm(xg, sg, bg, activ="relu", mesh=mesh)
        (y * torch.cos(xl)).sum().backward()
        out.update(adain=y.detach(), adain_dx=xg.grad, adain_dscale=sg.grad,
                   adain_dshift=bg.grad)
        torch.save(out, os.path.join(out_dir, f"halo.{rank}.pt"))
    finally:
        halo._point_to_point = chooser
        teardown()


def spatial_cases(rank, world, port, cases, out_dir, device_type="cpu"):
    """For each case (name, kind, n_data, n_spatial, config dict, snapshot
    path, global NHWC x_a, x_b, z): on the ranks of an n_data x n_spatial
    grid over the first processes, with this rank's rows and H-slice, either
    one sharded `translate` of x_a with styles z (kind "translate") or one
    D+G `train_step` on the injected global z (kind "step"); saves the
    output (or the metrics and the five networks' state) to
    out_dir/<name>.<rank>.pt. Ranks outside a case's grid skip it."""
    from aclgan_tpu_torch.config import from_dict
    from aclgan_tpu_torch.parallel.mesh import shard_state
    from aclgan_tpu_torch.parallel.spatial import make_mesh_2d, spatial_batch_sharding
    from aclgan_tpu_torch.trainer import ACLGAN

    device = init_rank(rank, world, port, device_type)
    meshes, models = {}, []
    try:
        for name, kind, n_data, n_spatial, cfg_dict, snap_path, x_a, x_b, z in cases:
            if (n_data, n_spatial) not in meshes:  # every rank makes every grid
                meshes[n_data, n_spatial] = make_mesh_2d(n_data, n_spatial)
            mesh = meshes[n_data, n_spatial]
            if mesh is None:
                continue
            model = ACLGAN(from_dict(cfg_dict), device=device, mesh=mesh)
            models.append(model)
            model.init_state()
            model.restore(torch.load(snap_path, map_location="cpu", weights_only=True))
            shard_state(model, mesh)
            rows, hs = spatial_batch_sharding(mesh, x_a.shape[0], x_a.shape[1])
            xa, xb = x_a[rows, hs], x_b[rows, hs]
            if kind == "translate":
                img, mask = model.translate(xa, z[rows])
                result = {"img": img.cpu(), "mask": mask.cpu()}
            else:
                metrics = model.train_step(xa, xb, True, True, z=z)
                snap = model.snapshot()
                result = {"metrics": {k: v.cpu() for k, v in metrics.items()},
                          "gen": snap["gen"], "dis": snap["dis"]}
            torch.save(result, os.path.join(out_dir, f"{name}.{rank}.pt"))
    finally:
        teardown(models)


# ------------------------------------------------ CUDA graphs' stand-in
class _Recorder(TorchDispatchMode):
    """Runs and records every op dispatched while it is on: (op, args,
    kwargs, output)."""

    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class _RefuseHostCopies(TorchFunctionMode):
    """What a CUDA capture refuses and the CPU runs: a tensor element set from
    a Python number (`t[i] = 0.0` on a CUDA tensor copies the number from
    pageable host memory and waits for it, which ends a capture with
    "operation not permitted when stream is capturing")."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__setitem__ and isinstance(args[2], (bool, int, float)):
            raise RuntimeError("operation not permitted when stream is capturing: an element "
                               f"set from the Python number {args[2]!r} is copied from the host")
        return func(*args, **(kwargs or {}))


def _into(recorded, new, pending):
    """Write a re-run op's result into the tensors its capture produced;
    collect the c10d works it returned."""
    if isinstance(recorded, torch.Tensor):
        same = (new is recorded or (new.data_ptr() == recorded.data_ptr()
                                    and new.shape == recorded.shape
                                    and new.stride() == recorded.stride()))
        if not same:
            recorded.copy_(new)
    elif isinstance(recorded, (list, tuple)):
        for r, n in zip(recorded, new):
            _into(r, n, pending)
    elif isinstance(new, torch.ScriptObject):
        pending.append(Work.unbox(new))


class ReplayGraph:
    """A CUDA graph's interface on the CPU that does what one does: the ops
    issued between `capture_begin` and `capture_end` (autograd's backward and
    the c10d collectives among them) are recorded with their tensors, and a
    replay runs them again on those tensors, each result written where the
    capture's went, the kernels' counters left as they were (a replay calls
    no wrapper). The capture runs the body on the CPU, so the replay that
    follows it at once is skipped: each call runs the step once, as on the
    card. A capture refuses what a CUDA capture refuses and the CPU would
    run (`_RefuseHostCopies`). `reset` destroys it as `CUDAGraph.reset`
    does, and counts."""

    def __init__(self):
        self.generators, self.ops, self.replays, self.resets = [], [], 0, 0
        self._mode = None
        self._skip = False

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self._mode = (_Recorder(self.ops), _RefuseHostCopies())
        for mode in self._mode:
            mode.__enter__()

    def capture_end(self):
        for mode in reversed(self._mode):
            mode.__exit__(None, None, None)
        self._skip = True

    def replay(self):
        self.replays += 1
        if self._skip:
            self._skip = False
            return
        from aclgan_tpu_torch.ops.kernels import instance_norm as K

        counts = [getattr(K, c) for c in K.COUNTERS]
        pending = []
        with torch.no_grad():
            for func, args, kwargs, out in self.ops:
                is_c10d = func.namespace == "c10d"
                if not is_c10d:  # a collective's result is read by the ops after it
                    for work in pending:
                        work.wait()
                    pending.clear()
                _into(out, func(*args, **kwargs), pending)
        for work in pending:
            work.wait()
        for c, v in zip(K.COUNTERS, counts):
            setattr(K, c, v)

    def reset(self):
        self.resets += 1
        self.ops = []

    def pool(self):
        return "the pool"


def cpu_graphs(graph=ReplayGraph):
    """`StepGraphs` on the CPU with `graph` for `torch.cuda.CUDAGraph`."""
    from aclgan_tpu_torch.graphs import StepGraphs

    class CpuGraphs(StepGraphs):
        def __init__(self):
            super().__init__(torch.device("cpu"))
            self.made = []

        def _new_graph(self):
            self.made.append(graph())
            return self.made[-1]

        def _on_device(self):
            return contextlib.nullcontext()

        def _side(self):
            return contextlib.nullcontext()

        def _in_order(self):
            return contextlib.nullcontext()

        def _free_cached(self):
            return 0

        def _reserved(self):
            return 0

    return CpuGraphs()


def count_plain_launches():
    """Count each call of the instance norm's plain version (the CPU's K1)
    in `launches`, as the card's wrapper counts K1."""
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    plain = K.instance_norm_plain

    def counted(*args, **kwargs):
        K.launches += 1
        return plain(*args, **kwargs)

    K.instance_norm_plain = counted


GRAPH_SCHEDULE = ((True, True), (True, False), (True, True), (True, True), (True, False))


def graph_ranks(rank, world, port, cfg_dict, snap_path, x_a, x_b, displays, out_dir):
    """On this rank of a gloo `DataMesh`: `GRAPH_SCHEDULE`'s iterations on its
    rows of the global batches, drawn z, eager and through `cpu_graphs()`
    (each iteration's metrics and K1 count, the final state); `sample` on
    `displays` three times, eager and graphed; then a key captured
    differently on each rank, and a capture that fails on rank 1 alone.
    Saves them to out_dir/graphs.<rank>.pt."""
    from aclgan_tpu_torch.config import from_dict
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_state
    from aclgan_tpu_torch.trainer import ACLGAN

    _join(rank, world, port)
    count_plain_launches()
    models = []
    try:
        mesh = make_mesh(-1)
        rows = batch_sharding(mesh, x_a.shape[1])
        out = {}
        for form in ("eager", "graphed"):
            model = ACLGAN(from_dict(cfg_dict), device="cpu", mesh=mesh)
            models.append(model)
            model.init_state()
            model.restore(torch.load(snap_path, weights_only=True))
            shard_state(model, mesh)
            if form == "graphed":
                model.graphs = cpu_graphs()
            steps = []
            for i, (do_dis, do_gen) in enumerate(GRAPH_SCHEDULE):
                k1 = K.launches
                m = model.train_step(x_a[i][rows], x_b[i][rows], do_dis, do_gen)
                steps.append(({k: v.clone() for k, v in m.items()}, K.launches - k1))
            samples = []
            for xa, xb, z in displays:
                k1 = K.launches
                outs = model.sample(xa, xb, *z)
                samples.append(([o.clone() for o in outs], K.launches - k1))
            snap = model.snapshot()
            out[form] = {"steps": steps, "samples": samples, "gen": snap["gen"],
                         "dis": snap["dis"], "step": model.step}
            if form == "graphed":
                out["keys"] = model.graphs.keys()
                out["replays"] = [g.replays for g in model.graphs.made]
        errors = {}
        graphs = cpu_graphs()
        for _ in range(2):  # each rank its own key: eager, then the capture's check
            try:
                graphs.run(("key of rank", rank), (torch.ones(1),), lambda t: t * 2, mesh=mesh)
            except RuntimeError as e:
                errors["mismatch"] = str(e)
        calls = []

        def body(t):
            calls.append(1)
            if rank == 1 and len(calls) == 2:
                raise ValueError("not capturable here")
            return t + 1

        for _ in range(2):
            try:
                graphs.run(("fails on rank 1",), (torch.ones(1),), body, mesh=mesh)
            except RuntimeError as e:
                errors["failed"] = str(e)
        out["errors"] = errors
        # the failed capture's graph, destroyed on both ranks before they raised
        out["failed_graph"] = {"resets": graphs.made[-1].resets,
                               "kept": ("fails on rank 1",) in graphs._entries}
        graphs.release()
        torch.save(out, os.path.join(out_dir, f"graphs.{rank}.pt"))
    finally:
        teardown(models)


def halo_forms(rank, world, port, x, cases, out_dir, device_type="cuda"):
    """`halo_rows` forward and backward on this rank's H-slice of the NCHW `x`
    over a 1 x world grid, for each (top, bottom, pad_type) of `cases`, in
    both forms of `HALO_FORMS`; the cotangent is cos of the output. Saves
    out_dir/halo_forms.<rank>.pt."""
    from aclgan_tpu_torch.parallel import halo
    from aclgan_tpu_torch.parallel.spatial import make_mesh_2d

    device = init_rank(rank, world, port, device_type)
    chooser = halo._point_to_point
    try:
        mesh = make_mesh_2d(1, world)
        h = x.shape[2] // world
        xl = x[:, :, rank * h:(rank + 1) * h].to(device)
        out = {}
        for form, p2p in HALO_FORMS.items():
            halo._point_to_point = lambda t, group, p2p=p2p: p2p and chooser(t, group)
            for top, bottom, pad_type in cases:
                xg = xl.clone().requires_grad_()
                y = halo.halo_rows(xg, top, bottom, mesh, pad_type)
                (y * torch.cos(y.detach())).sum().backward()
                out[form, top, bottom, pad_type] = (y.detach().cpu(), xg.grad.cpu())
        torch.save(out, os.path.join(out_dir, f"halo_forms.{rank}.pt"))
    finally:
        halo._point_to_point = chooser
        teardown()
