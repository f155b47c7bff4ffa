"""Processes of the port's data-parallel tests (not a test module). Spawned
ranks import this module and nothing of JAX: they join a gloo group on the
CPU (or, in the CUDA tests, an NCCL group of one rank a card) over localhost
and hand their results back through files."""

import os
import socket
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, args: tuple, timeout: float = 300.0) -> None:
    """Run fn(rank, world, port, *args) in `world` spawned processes; raise
    with each failed rank's traceback."""
    ctx = mp.get_context("spawn")
    port = free_port()
    errors = ctx.Queue()
    procs = [ctx.Process(target=_guarded, args=(fn, rank, world, port, args, errors))
             for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    failures = []
    while not errors.empty():
        failures.append(errors.get())
    if alive or failures or any(p.exitcode for p in procs):
        raise RuntimeError(f"ranks alive after {timeout} s: {len(alive)}; exit codes "
                           f"{[p.exitcode for p in procs]}\n" + "\n".join(failures))


def _guarded(fn, rank, world, port, args, errors):
    torch.set_num_threads(1)
    try:
        fn(rank, world, port, *args)
    except BaseException:
        errors.put(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _join(rank, world, port):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)


def dp_steps(rank, world, port, cases, out_dir, device_type="cpu"):
    """For each case (name, config dict, snapshot path, global x_a, x_b, z),
    one D+G iteration on this rank's rows; saves the metrics and the state
    of the five networks to out_dir/<name>.<rank>.pt. With device_type
    "cuda" the rank runs on card `rank` over NCCL, with TF32 off."""
    from aclgan_tpu_torch.config import from_dict
    from aclgan_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_state
    from aclgan_tpu_torch.trainer import ACLGAN

    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
    else:
        device = torch.device("cpu")
        _join(rank, world, port)
    try:
        mesh = make_mesh(-1)
        for name, cfg_dict, snap_path, x_a, x_b, z in cases:
            model = ACLGAN(from_dict(cfg_dict), device=device, mesh=mesh)
            model.init_state()
            model.restore(torch.load(snap_path, map_location="cpu", weights_only=True))
            shard_state(model, mesh)
            rows = batch_sharding(mesh, x_a.shape[0])
            metrics = model.train_step(x_a[rows], x_b[rows], True, True, z=z)
            snap = model.snapshot()
            torch.save({"metrics": metrics, "gen": snap["gen"], "dis": snap["dis"]},
                       os.path.join(out_dir, f"{name}.{rank}.pt"))
    finally:
        dist.destroy_process_group()


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


def _init(rank, world, port, device_type):
    """Join the group: gloo on the CPU, or NCCL with this rank on card `rank`
    (TF32 off). Returns the rank's device."""
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        return device
    _join(rank, world, port)
    return torch.device("cpu")


def halo_ops(rank, world, port, x, g, convs, gamma, beta, scale, shift, out_dir):
    """The spatial ops on this rank's H-slice of the NCHW `x` (H split over all
    `world` ranks of a 1 x world grid): `halo_conv` for each entry of `convs`
    ({name: (weight, bias, stride, padding, pad_type, H)}, on x's first H
    rows), the sharded IN, LN,
    pools, the gradient of `halo_rows` against the cotangent `g` of its
    output, and the split AdaIN (`fused_instance_norm` under the mesh) with
    its gradients; saves them to out_dir/halo.<rank>.pt."""
    from aclgan_tpu_torch.ops import norms, pool
    from aclgan_tpu_torch.ops.kernels.instance_norm import fused_instance_norm
    from aclgan_tpu_torch.parallel import halo
    from aclgan_tpu_torch.parallel.spatial import make_mesh_2d

    _join(rank, world, port)
    try:
        mesh = make_mesh_2d(1, world)
        h = x.shape[2] // world
        xl = x[:, :, rank * h:(rank + 1) * h].contiguous()
        out = {}
        for name, (w, b, stride, padding, pad_type, rows) in convs.items():
            hc = rows // world
            out[name] = halo.halo_conv(x[:, :, rank * hc:(rank + 1) * hc].contiguous(), w, b,
                                       mesh, stride, padding, pad_type)
        out["in"] = halo.sharded_instance_norm(xl, mesh)
        out["ln"] = norms.sample_layer_norm(xl, gamma, beta, mesh=mesh)
        out["pool"] = pool.avg_pool_3x3_s2(xl, mesh)
        out["gap"] = pool.global_avg_pool(xl, mesh)
        for pad_type, (top, bottom, gl) in g.items():
            xg = xl.clone().requires_grad_()
            gr = gl[:, :, rank * h:rank * h + h + top + bottom]
            (halo.halo_rows(xg, top, bottom, mesh, pad_type) * gr).sum().backward()
            out[f"halo_grad_{pad_type}"] = xg.grad
        xg, sg, bg = (t.clone().requires_grad_() for t in (xl, scale, shift))
        y = fused_instance_norm(xg, sg, bg, activ="relu", mesh=mesh)
        (y * torch.cos(xl)).sum().backward()
        out.update(adain=y.detach(), adain_dx=xg.grad, adain_dscale=sg.grad,
                   adain_dshift=bg.grad)
        torch.save(out, os.path.join(out_dir, f"halo.{rank}.pt"))
    finally:
        dist.destroy_process_group()


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

    device = _init(rank, world, port, device_type)
    meshes = {}
    try:
        for name, kind, n_data, n_spatial, cfg_dict, snap_path, x_a, x_b, z in cases:
            if (n_data, n_spatial) not in meshes:  # every rank makes every grid
                meshes[n_data, n_spatial] = make_mesh_2d(n_data, n_spatial)
            mesh = meshes[n_data, n_spatial]
            if mesh is None:
                continue
            model = ACLGAN(from_dict(cfg_dict), device=device, mesh=mesh)
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
        dist.destroy_process_group()
