"""The spawn harness of the port's multi-rank runs: `spawn` starts one process
a rank over localhost and bounds them all by one deadline. A rank still
running shortly before it writes its Python stack and its collective log
(PyTorch's flight recorder) into the spawn's dump directory and exits, each
group's timeout (`group_timeout`) ends a collective that waits on a hung peer
before that, and the spawn raises with every rank's exit code, traceback,
stack and log. `torchrun` bounds a run of the torchrun launcher the same
way. `teardown` destroys a rank's CUDA graphs before its process group.
`mesh_graph_steps` is the rank body of the graphed mesh step's checks. The
CPU tests, `chip_smoke.py` and `tools/torch_mesh_graphs.py` share them.
Imports nothing of JAX, and torch only inside the functions that use it, so
that a rank arms its watch (`watch_torchrun_rank`) before its slow
`import torch`."""

import contextlib
import datetime
import faulthandler
import glob
import json
import multiprocessing.connection
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

_DEADLINE = "ACLGAN_SPAWN_DEADLINE"  # the spawn's deadline (time.time()), set in each rank
_FR_PREFIX = "collectives."          # the flight recorder's dump files: <prefix><rank>
_DUMP_DIR = "ACLGAN_DUMP_DIR"        # where a rank that torchrun started dumps
RANK_STDERR = "ACLGAN_RANK_STDERR"   # a directory: each spawned rank's stderr to stderr.<rank>.txt


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dump_margin(timeout: float) -> float:
    """The seconds before a spawn's deadline at which a live rank dumps and exits."""
    return min(10.0, 0.25 * timeout)


def spawn(fn, world: int, args: tuple, timeout: float = 300.0, dump_dir=None) -> None:
    """Run fn(rank, world, port, *args) in `world` spawned processes, all under
    one deadline `timeout` s away. A rank still running `dump_margin` s before
    it writes its collective log and its Python stack (every thread) into
    `dump_dir` (a new temporary directory when None, removed after a
    clean run) and exits; at the
    deadline the ranks left are killed. Raises if a rank failed or was cut,
    with each rank's exit code, traceback, stack and collective log."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    made = dump_dir is None
    dump_dir = str(dump_dir or tempfile.mkdtemp(prefix="spawn_dumps_"))
    os.makedirs(dump_dir, exist_ok=True)
    deadline = time.time() + timeout
    port = free_port()
    procs = [ctx.Process(target=_guarded, args=(fn, rank, world, port, args, dump_dir,
                                                deadline, timeout))
             for rank in range(world)]
    for p in procs:
        p.start()
    pending = list(procs)
    while pending and time.time() < deadline:
        multiprocessing.connection.wait([p.sentinel for p in pending],
                                        deadline - time.time())
        pending = [p for p in pending if p.is_alive()]
    for p in pending:
        p.kill()
    for p in procs:
        p.join(10)
    codes = [p.exitcode for p in procs]
    if pending or any(codes):
        raise RuntimeError(f"spawn of {world} ranks of {getattr(fn, '__name__', fn)}: "
                           f"{len(pending)} alive at the {timeout:.0f} s deadline (killed); "
                           f"exit codes {codes}\n" + rank_dumps(dump_dir, world))
    if made:
        shutil.rmtree(dump_dir, ignore_errors=True)


def rank_dumps(dump_dir: str, world: int) -> str:
    """Each rank's traceback, Python stack dump and collective log, as text."""
    parts = []
    for rank in range(world):
        for what, name in (("traceback", f"error.{rank}.txt"),
                           ("stack at the deadline or a crash", f"stack.{rank}.txt")):
            path = os.path.join(dump_dir, name)
            if os.path.exists(path) and os.path.getsize(path):
                with open(path, errors="replace") as f:
                    parts.append(f"--- rank {rank}: {what}\n{f.read()}")
        for path in sorted(glob.glob(os.path.join(dump_dir, f"{_FR_PREFIX}{rank}*"))):
            parts.append(f"--- rank {rank}: collective log {os.path.basename(path)}\n"
                         + collective_log(path))
    return "\n".join(parts)


def collective_log(path: str) -> str:
    """A flight-recorder dump as one line a collective: sequence ids, name,
    state, sizes (the JSON form; a pickled one from a timeout as its entries)."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        doc = json.loads(raw)
    except ValueError:
        import pickle

        try:
            doc = pickle.loads(raw)  # the dump a timeout writes; ours, from this spawn
        except Exception as e:  # a partial file: say so, keep the rest of the report
            return f"(unreadable: {type(e).__name__}: {e})"
    lines = []
    for e in doc.get("entries", []):
        lines.append(f"  seq {e.get('collective_seq_id')} p2p {e.get('p2p_seq_id')} "
                     f"pg {e.get('process_group')} {e.get('profiling_name')} "
                     f"{e.get('state')} in {e.get('input_sizes')} "
                     f"retired {e.get('retired')}")
    return "\n".join(lines) or "  (no entries)"


def flight_recorder_env(dump_dir: str) -> dict:
    """PyTorch's flight recorder, on for the groups a rank makes after this:
    its buffer, its dump on a collective's timeout, and the dump files'
    prefix (both names the torch versions read)."""
    prefix = os.path.join(dump_dir, _FR_PREFIX)
    return {"TORCH_NCCL_TRACE_BUFFER_SIZE": "4000", "TORCH_FR_BUFFER_SIZE": "4000",
            "TORCH_NCCL_DUMP_ON_TIMEOUT": "1", "TORCH_NCCL_DEBUG_INFO_TEMP_FILE": prefix,
            "TORCH_FR_DUMP_TEMP_FILE": prefix}


def group_timeout() -> datetime.timedelta:
    """A process group's timeout inside a spawn: half the time left before
    the dump, so that a collective waiting on a hung peer times out (and its
    log is written) first; 30 min outside a spawn."""
    deadline = os.environ.get(_DEADLINE)
    if deadline is None:
        return datetime.timedelta(minutes=30)
    margin = float(os.environ.get(_DEADLINE + "_MARGIN", 0.0))
    return datetime.timedelta(seconds=max(2.0, 0.5 * (float(deadline) - margin - time.time())))


def dump_collectives(path: str) -> None:
    """Write this process's flight-recorder entries (JSON) to `path`
    (nothing in a process that never imported torch: it made no group)."""
    if "torch" not in sys.modules:
        return
    import torch._C._distributed_c10d as c10d

    for name in ("_dump_nccl_trace_json", "_dump_fr_trace_json"):
        dump = getattr(c10d, name, None)
        if dump is not None:
            with contextlib.suppress(RuntimeError):  # no group made yet
                raw = dump(True, False)
                with open(path, "wb") as f:
                    f.write(raw if isinstance(raw, bytes) else raw.encode())
                return


def _watch(rank, dump_dir, deadline, margin):
    """Arm this process to write its collective log and then its Python stack
    (every thread) into `dump_dir` `margin` s before `deadline`, and to exit
    there; returns the function that disarms both."""
    left = max(0.5, deadline - margin - time.time())
    stack = open(os.path.join(dump_dir, f"stack.{rank}.txt"), "w")
    faulthandler.enable(stack)
    faulthandler.dump_traceback_later(left, exit=True, file=stack)
    # a launcher that stops the rank because a peer exited at its dump (torchrun
    # does, with SIGTERM) gets this rank's stack too, then the signal's default
    faulthandler.register(signal.SIGTERM, file=stack, all_threads=True, chain=True)
    log = threading.Timer(max(0.1, left - min(3.0, margin / 2)), dump_collectives,
                          (os.path.join(dump_dir, f"{_FR_PREFIX}{rank}.at_deadline.json"),))
    log.daemon = True
    log.start()

    def disarm():
        log.cancel()
        faulthandler.cancel_dump_traceback_later()
        faulthandler.unregister(signal.SIGTERM)

    return disarm


def _guarded(fn, rank, world, port, args, dump_dir, deadline, timeout):
    import torch

    torch.set_num_threads(1)
    if os.environ.get(RANK_STDERR):  # this rank's stderr, c10d's log among it, to a file
        log = open(os.path.join(os.environ[RANK_STDERR], f"stderr.{rank}.txt"), "a")
        os.dup2(log.fileno(), 2)
    margin = dump_margin(timeout)
    os.environ.update(flight_recorder_env(dump_dir))
    os.environ[_DEADLINE], os.environ[_DEADLINE + "_MARGIN"] = str(deadline), str(margin)
    disarm = _watch(rank, dump_dir, deadline, margin)
    try:
        fn(rank, world, port, *args)
    except BaseException:
        with open(os.path.join(dump_dir, f"error.{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        dump_collectives(os.path.join(dump_dir, f"{_FR_PREFIX}{rank}.at_error.json"))
        raise
    finally:
        disarm()


def torchrun(argv, world: int, timeout: float, dump_dir, env=None):
    """`python -m torch.distributed.run --standalone --nproc_per_node world
    argv...` (a script and its arguments) under one deadline `timeout` s
    away, in a session of its own; returns (its stdout lines, seconds). A
    rank that calls `watch_torchrun_rank` dumps as a spawned rank does
    (`spawn`) and exits near the deadline; what is left at it is killed.
    Raises on a non-zero exit or the deadline with the output's tail and
    every rank's dumps."""
    dump_dir = str(dump_dir)
    os.makedirs(dump_dir, exist_ok=True)
    deadline = time.time() + timeout
    env = dict(os.environ, **(env or {}), **flight_recorder_env(dump_dir))
    env.update({_DEADLINE: str(deadline), _DEADLINE + "_MARGIN": str(dump_margin(timeout)),
                _DUMP_DIR: dump_dir})
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(world)] + [str(a) for a in argv]
    t0 = time.time()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        # the ranks exit at the dump; torchrun then ends the rest within seconds
        out, err = proc.communicate(timeout=timeout + 30)
        cut = ""
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        cut = f"killed at the {timeout:.0f} s deadline; "
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)  # a rank torchrun left behind
    if cut or proc.returncode:
        raise RuntimeError(f"torchrun of {world} ranks {argv[:3]}: {cut}exit {proc.returncode}"
                           f"\n{out[-2000:]}\n{err[-4000:]}\n" + rank_dumps(dump_dir, world))
    return out.splitlines(), time.time() - t0


def watch_torchrun_rank() -> None:
    """In a rank that `torchrun` started: arm it to dump its stack and its
    collective log near the run's deadline and exit (nothing outside such a
    run)."""
    if _DUMP_DIR in os.environ:
        _watch(int(os.environ["RANK"]), os.environ[_DUMP_DIR],
               float(os.environ[_DEADLINE]), float(os.environ[_DEADLINE + "_MARGIN"]))


def teardown(models=()) -> None:
    """Destroy each model's CUDA graphs, then the process group: a live
    graph's NCCL collectives hold the group's communicators, and their
    destroy waits for every graph that references them."""
    import torch.distributed as dist

    for model in models:
        model.release_graphs()
    dist.destroy_process_group()


def init_rank(rank, world, port, device_type):
    """Join the group: gloo on the CPU, or NCCL with this rank on card `rank`
    (TF32 off). Returns the rank's device."""
    import torch
    import torch.distributed as dist

    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world, timeout=group_timeout())
        return device
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world, timeout=group_timeout())
    return torch.device("cpu")


def _live_graphs(mark, when, models):
    """Mark the live `torch.cuda.CUDAGraph` objects (after a collection) and
    the `StepGraphs` entries of `models`."""
    import gc

    import torch

    gc.collect()
    graph_type = getattr(torch._C, "_CUDAGraph", torch.cuda.CUDAGraph)
    graphs = sum(issubclass(type(o), graph_type) for o in gc.get_objects())
    entries = sum(len(m.graphs._entries) for m in models if m.graphs is not None)
    mark(f"{when}: {graphs} live CUDAGraph objects, {entries} StepGraphs entries")


def _state_rel(a, b) -> float:
    """rel-L2 of one step's networks (`gen` and `dis` state dicts) from
    another's, over every tensor at once."""
    import torch

    def flat(x):
        return torch.cat([t.double().flatten() for kind in ("gen", "dis")
                          for _, sd in sorted(x[kind].items()) for _, t in sorted(sd.items())])

    fa, fb = flat(a), flat(b)
    return float((fa - fb).norm() / fb.norm().clamp_min(1e-30))


def mesh_graph_steps(rank, world, port, cases, out_dir, device_type="cuda",
                     release=True, halo_p2p=True, explicit_teardown=False, eager_copies=1):
    """For each case, in one process group: three D+G iterations on this
    rank's share (a `DataMesh` when n_spatial is 1, else an n_data x
    n_spatial grid) of the global NHWC batches, on the injected global z of
    each: the first eager, the second captured and replayed, the third
    replayed; then the third from the same state in an eager twin
    (`graphs=False`); on the CPU through `cpu_graphs()`. Each case =
    (name, n_data, n_spatial, config dict, snapshot path, x_a, x_b,
    [z, z, z]); its models' graphs are destroyed and the models dropped
    before the next case, and the last case's before the group goes
    (`teardown`); `release` False leaves every graph alive until Python
    collects it (a reproduction of the teardown with graphs alive). A mesh the
    trainer keeps eager (gloo on CUDA tensors) runs eagerly in both forms (no
    keys). `halo_p2p` False sends every halo through
    its all-reduce form (`parallel/halo.py`), which tells a hang of the
    point-to-point sends from one of the all-reduces. `explicit_teardown`
    (a diagnosis of a teardown's hang) counts the live `torch.cuda.CUDAGraph`
    objects and `StepGraphs` entries before and after the release,
    synchronizes, and destroys each group by itself (each grid's data, then
    spatial, then world group, then the default one), a line of progress
    before and after each in out_dir/progress.<rank>.txt. With
    `eager_copies` > 1 that many eager twins step from the state (phase
    29's rule): the rel-L2 of each pair of them (`eager_pairs`) and of the
    replayed step from the first (`graphed_rel`) are saved too. Saves
    out_dir/mesh.<name>.<rank>.pt: the state before the third iteration
    (rank 0), the third iteration's metrics, networks and (K1, K2, K1m,
    K1a, K2m, K2a) in both forms, the graphs' keys and capture bytes."""
    import copy

    import torch
    import torch.distributed as dist

    from aclgan_tpu_torch.config import from_dict
    from aclgan_tpu_torch.ops.kernels import instance_norm as K
    from aclgan_tpu_torch.parallel import halo
    from aclgan_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_state
    from aclgan_tpu_torch.parallel.spatial import make_mesh_2d, spatial_batch_sharding
    from aclgan_tpu_torch.trainer import ACLGAN

    if not halo_p2p:
        halo._point_to_point = lambda t, group: False
    progress = open(os.path.join(out_dir, f"progress.{rank}.txt"), "a", buffering=1)

    def mark(msg):
        progress.write(f"{time.time():.3f} {msg}\n")

    device = init_rank(rank, world, port, device_type)
    meshes, alive = {}, []
    try:
        for name, n_data, n_spatial, cfg_dict, snap_path, x_a, x_b, zs in cases:
            if (n_data, n_spatial) not in meshes:  # every rank makes every grid
                meshes[n_data, n_spatial] = (make_mesh(-1) if n_spatial == 1
                                             else make_mesh_2d(n_data, n_spatial))
            mesh = meshes[n_data, n_spatial]
            if n_spatial == 1:
                rows, hs = batch_sharding(mesh, x_a.shape[0]), slice(None)
            else:
                rows, hs = spatial_batch_sharding(mesh, x_a.shape[0], x_a.shape[1])
            xa, xb = x_a[rows, hs], x_b[rows, hs]

            def model_(graphs):
                m = ACLGAN(from_dict(cfg_dict), device=device, mesh=mesh, graphs=graphs)
                m.init_state()
                return m

            def third(m):
                before = [getattr(K, c) for c in K.COUNTERS]
                metrics = m.train_step(xa, xb, True, True, z=zs[2])
                snap = m.snapshot()
                return {"metrics": {k: float(v) for k, v in metrics.items()},
                        "launches": tuple(getattr(K, c) - b
                                          for c, b in zip(K.COUNTERS, before)),
                        "gen": {n: {k: v.cpu() for k, v in sd.items()}
                                for n, sd in snap["gen"].items()},
                        "dis": {n: {k: v.cpu() for k, v in sd.items()}
                                for n, sd in snap["dis"].items()}}

            model = model_(True)
            alive.append(model)
            if device.type == "cpu":  # the tests' stand-in graph: the CPU has no CUDA graphs
                from tests.torch_dp_worker import cpu_graphs

                model.graphs = cpu_graphs()
            model.restore(torch.load(snap_path, map_location="cpu", weights_only=True))
            shard_state(model, mesh)
            for z in zs[:2]:
                model.train_step(xa, xb, True, True, z=z)
            state = copy.deepcopy(model.snapshot())
            out = {"graphed": third(model),
                   "keys": model.graphs.keys() if model.graphs else [],
                   "capture_bytes": dict(model.graphs.capture_bytes) if model.graphs else {}}
            # a restored optimizer's moments are the state's own tensors, which
            # its step updates in place: each twin gets a copy
            twin = model_(False)
            twin.restore(copy.deepcopy(state))
            out["eager"] = third(twin)
            if eager_copies > 1:
                copies = [out["eager"]]
                for _ in range(eager_copies - 1):
                    twin = model_(False)
                    twin.restore(copy.deepcopy(state))
                    copies.append(third(twin))
                out["eager_pairs"] = [_state_rel(copies[i], copies[j])
                                      for i in range(1, len(copies)) for j in range(i)]
                out["graphed_rel"] = _state_rel(out["graphed"], copies[0])
                del copies
            if rank == 0:
                out["state"] = state
            torch.save(out, os.path.join(out_dir, f"mesh.{name}.{rank}.pt"))
            if explicit_teardown:
                _live_graphs(mark, f"{name}: before the release", [model])
            if release:
                model.release_graphs()
            if explicit_teardown:
                _live_graphs(mark, f"{name}: after the release", [model])
            alive.clear()
            del model, twin
    finally:
        raised = sys.exc_info()[1]
        if raised is not None:  # before a teardown that may not return
            mark(f"raised {type(raised).__name__}: {raised}")
        if explicit_teardown:
            _live_graphs(mark, "before the teardown", alive)
            if release:
                for m in alive:
                    m.release_graphs()
            if device.type == "cuda":
                torch.cuda.synchronize()
            mark("synchronized")
            for (n_data, n_spatial), mesh in meshes.items():
                for what in ("data_group", "spatial_group", "world_group"):
                    group = getattr(mesh, what, None)
                    if group is not None:
                        mark(f"{n_data} x {n_spatial}: destroy {what}")
                        dist.destroy_process_group(group)
                        mark(f"{n_data} x {n_spatial}: {what} destroyed")
            mark("destroy the default group")
            dist.destroy_process_group()
            mark("default group destroyed")
        else:
            teardown(alive if release else ())
