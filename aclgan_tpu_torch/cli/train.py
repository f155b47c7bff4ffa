"""Training CLI — `python -m aclgan_tpu_torch.cli.train --config <yaml>`.

Port of `aclgan_tpu/cli/train.py` on one device (CUDA unless `--device cpu`):

- D/G cadence on the *epoch-local* index `it`, as the reference does (the
  cadence counter resets each epoch while `iterations` is global; at an odd
  epoch length G runs on two iterations in a row across the boundary);
  iterations that run neither update are folded into the next step's
  `step_increment`, so the step and the StepLR schedule stay global;
- fixed display noise drawn once, from a `torch.Generator` seeded
  `cfg.seed + 17` (`display_noise`);
- JSONL (and TensorBoard) scalars every log_iter, with the last-seen value of
  each, copied to the host as one stacked tensor; image grids + HTML every
  image_save_iter and `train_current` every image_display_iter; a snapshot
  set every snapshot_save_iter and at the end;
- `--resume` restores networks, optimizers, EMA, step and the z stream from
  the newest snapshot set, the port's `.pt` or a JAX run's `.msgpack` (whose
  z stream restarts from (seed, step));
- `--profile_dir` writes a `torch.profiler` trace of iterations 10..14.

Across GPUs, one process a GPU: `torchrun --nproc_per_node N -m
aclgan_tpu_torch.cli.train --config C` with `tpu.distributed: true`
(`parallel/mesh.py`; gloo with `--device cpu`). Each rank loads
batch_size / N samples with seed `cfg.seed + rank`, steps on them as its
share of the global batch, and holds the same state; rank 0 alone writes
files (scalars, grids, HTML, snapshots, the config), and its display batches
are broadcast to every rank. `--resume` reads the snapshot on every rank,
then broadcasts rank 0's state. A single process with `tpu.mesh_data > 1`
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from aclgan_tpu_torch.config import Config, load_config, save_config
from aclgan_tpu_torch.data.loader import DataLoader, device_prefetch, get_all_data_loaders
from aclgan_tpu_torch.parallel.mesh import (DataMesh, coordination_barrier,
                                            init_distributed, make_mesh, replicate,
                                            shard_state)
from aclgan_tpu_torch.trainer import ACLGAN, resolve_device
from aclgan_tpu_torch.utils.checkpoint import resume, save_checkpoint
from aclgan_tpu_torch.utils.image import write_2images
from aclgan_tpu_torch.utils.logging import MetricWriter, prepare_sub_folder, write_html

TRACE_FIRST, TRACE_END = 10, 15  # iterations the --profile_dir trace covers


def display_noise(cfg: Config, n: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fixed (z1, z2, z3) of the display grids, each (n, style_dim)."""
    gen = torch.Generator().manual_seed(cfg.seed + 17)
    return tuple(torch.randn((n, cfg.style_dim), generator=gen).to(device)
                 for _ in range(3))


class TrainRun(NamedTuple):
    """What `main` leaves: the trained model, the display batches it sampled
    (train a, train b, test a, test b; NHWC float32 in [-1, 1]) and the
    iterations run."""

    model: ACLGAN
    displays: List[np.ndarray]
    iterations: int


def rank_loaders(cfg: Config, mesh: Optional[DataMesh]):
    """(train_a, train_b, test_a, test_b) of this rank: batch_size / world
    samples, seed `cfg.seed + rank`; exits as the JAX CLI does when the
    world does not divide the batch."""
    if mesh is None:
        return get_all_data_loaders(cfg, seed=cfg.seed)
    if cfg.batch_size % mesh.world:
        sys.exit(f"batch_size {cfg.batch_size} not divisible by {mesh.world} processes")
    local = dataclasses.replace(cfg, batch_size=cfg.batch_size // mesh.world)
    return get_all_data_loaders(local, seed=cfg.seed + mesh.rank)


def display_batches(loaders: List[DataLoader], display_size: int,
                    mesh: Optional[DataMesh]) -> List[np.ndarray]:
    """The first `display_size` items of each loader, clamped to the smallest
    dataset; rank 0's on every rank (each rank's loaders draw with its own
    seed)."""
    displays = [loader.first_n(display_size) for loader in loaders]
    # clamp to the smallest dataset: first_n returns min(n, len(dataset))
    n_avail = min(len(d) for d in displays)
    if n_avail < display_size:
        print(f"display_size {display_size} > smallest dataset ({n_avail}); clamping")
    displays = [np.ascontiguousarray(d[:n_avail]) for d in displays]
    if mesh is not None:
        tensors = [torch.from_numpy(d) for d in displays]
        if dist.get_backend() == "nccl":  # NCCL moves device tensors only
            tensors = [t.cuda() for t in tensors]
        replicate(tensors, mesh)
        displays = [t.cpu().numpy() for t in tensors]
    return displays


def _start_trace(device: torch.device) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof: torch.profiler.profile, profile_dir: str) -> None:
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile trace written to {path}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="configs/male2female.yaml",
                        help="Path to the config file.")
    parser.add_argument("--output_path", type=str, default=".", help="outputs path")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--trainer", type=str, default="aclgan", help="aclgan")
    parser.add_argument("--max_iter", type=int, default=None,
                        help="override config max_iter (smoke runs)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of iterations 10..14")
    parser.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    opts = parser.parse_args(argv)

    if opts.trainer != "aclgan":
        sys.exit("Only support aclgan")

    cfg = load_config(opts.config)
    device = resolve_device(opts.device)
    joined = cfg.tpu.distributed and not dist.is_initialized()
    if cfg.tpu.distributed:
        device = init_distributed(device.type)
    try:
        return _train(opts, cfg, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(opts, cfg: Config, device: torch.device) -> TrainRun:
    mesh = make_mesh(cfg.tpu.mesh_data)
    # file IO on rank 0 only: every rank holds the same state and metrics,
    # and concurrent writers would race on a shared filesystem
    is_main = mesh is None or mesh.rank == 0
    if opts.max_iter is not None:
        cfg.max_iter = opts.max_iter
    cfg.vgg_model_path = opts.output_path
    max_iter = cfg.max_iter
    display_size = cfg.display_size

    # Output folders + config snapshot
    model_name = os.path.splitext(os.path.basename(opts.config))[0]
    log_dir = os.path.join(opts.output_path, "logs", model_name)
    output_directory = os.path.join(opts.output_path, "outputs", model_name)
    if is_main:
        checkpoint_directory, image_directory = prepare_sub_folder(output_directory)
        save_config(cfg, os.path.join(output_directory, "config.yaml"))
    else:
        checkpoint_directory = os.path.join(output_directory, "checkpoints")
        image_directory = os.path.join(output_directory, "images")

    model = ACLGAN(cfg, device=device, mesh=mesh)
    model.init_state()
    shard_state(model, mesh)

    loaders = rank_loaders(cfg, mesh)
    train_loader_a, train_loader_b = loaders[:2]
    if len(train_loader_a) == 0 or len(train_loader_b) == 0:
        # drop_last with a dataset smaller than the batch yields 0 batches;
        # the epoch loop would spin forever
        sys.exit(f"training dataset smaller than batch_size="
                 f"{train_loader_a.batch_size}: trainA yields {len(train_loader_a)} "
                 f"batches, trainB {len(train_loader_b)} (drop_last)")
    displays = display_batches(loaders, display_size, mesh)
    display_size = len(displays[0])
    train_display_a, train_display_b, test_display_a, test_display_b = (
        torch.from_numpy(d).to(device) for d in displays)
    z_1, z_2, z_3 = display_noise(cfg, display_size, device)

    iterations = 0
    if opts.resume:
        # every rank reads the snapshot; rank 0's state then wins
        iterations = resume(checkpoint_directory, model)
        shard_state(model, mesh)
    coordination_barrier("train-loop")

    def do_sample(x_a, x_b):
        return [o.cpu().numpy() for o in model.sample(x_a, x_b, z_1, z_2, z_3)]

    print(f"Training {model_name}: {max_iter} iterations, batch {cfg.batch_size}, "
          f"{1 if mesh is None else mesh.world} device(s)")
    writer = MetricWriter(log_dir) if is_main else None
    t_last = time.time()
    # last-seen value per scalar: a logged step reports the most recent D and
    # G losses even when the cadence skipped one of them this iteration
    metrics_seen: Dict[str, torch.Tensor] = {}
    pending_skips = 0  # cadence-skipped iterations not yet folded into step
    trace: Optional[torch.profiler.profile] = None
    try:
        with torch.autograd.set_detect_anomaly(cfg.tpu.check_nans):
            while True:
                it_a = device_prefetch(train_loader_a, cfg.tpu.prefetch, device)
                it_b = device_prefetch(train_loader_b, cfg.tpu.prefetch, device)
                try:
                    for it, (images_a, images_b) in enumerate(zip(it_a, it_b)):
                        if (opts.profile_dir is not None and is_main
                                and iterations == TRACE_FIRST):
                            trace = _start_trace(device)
                        if trace is not None and iterations == TRACE_END:
                            _stop_trace(trace, opts.profile_dir)
                            trace = None

                        do_dis = (it % cfg.D_update) == 0
                        do_gen = (it % cfg.G_update) == 0
                        if do_dis or do_gen:
                            metrics = model.train_step(images_a, images_b, do_dis, do_gen,
                                                       1 + pending_skips)
                            pending_skips = 0
                        else:
                            # neither update runs; the reference still steps its
                            # LR scheduler: fold the skip into the next step
                            pending_skips += 1
                            metrics = {}

                        metrics_seen.update(metrics)
                        if (iterations + 1) % cfg.log_iter == 0 and is_main:
                            values = (torch.stack(list(metrics_seen.values())).tolist()
                                      if metrics_seen else [])
                            now = time.time()
                            print("Iteration: %08d/%08d (%.4fs)"
                                  % (iterations + 1, max_iter, now - t_last))
                            writer.write(iterations + 1, dict(zip(metrics_seen, values)))
                            t_last = now

                        # grids and snapshots: rank 0 alone (sampling runs no
                        # collective, so the other ranks skip it)
                        if (iterations + 1) % cfg.image_save_iter == 0 and is_main:
                            outs_test = do_sample(test_display_a, test_display_b)
                            outs_train = do_sample(train_display_a, train_display_b)
                            write_2images(outs_test, display_size, image_directory,
                                          "test_%08d" % (iterations + 1))
                            path = write_2images(outs_train, display_size, image_directory,
                                                 "train_%08d" % (iterations + 1))
                            write_html(os.path.join(output_directory, "index.html"),
                                       iterations + 1, cfg.image_save_iter, "images",
                                       ext=os.path.splitext(path)[1])

                        if (iterations + 1) % cfg.image_display_iter == 0 and is_main:
                            write_2images(do_sample(train_display_a, train_display_b),
                                          display_size, image_directory, "train_current")

                        if (iterations + 1) % cfg.snapshot_save_iter == 0 and is_main:
                            save_checkpoint(checkpoint_directory, model, iterations,
                                            keep=cfg.tpu.snapshot_keep)

                        iterations += 1
                        if iterations >= max_iter:
                            if trace is not None:  # the run ended inside the window
                                _stop_trace(trace, opts.profile_dir)
                            if is_main:
                                save_checkpoint(checkpoint_directory, model, iterations - 1)
                            coordination_barrier("snapshot-written")
                            print("Finish training")
                            return TrainRun(model, displays, iterations)
                finally:
                    it_a.close()
                    it_b.close()
    finally:
        if writer is not None:
            writer.close()


if __name__ == "__main__":
    main()
