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
