#!/usr/bin/env python3
"""The port's train step replayed as CUDA graphs across NCCL ranks, on 2-4
cards: the smallest reproductions of a teardown's hang, and the train CLI
under torchrun run again and again, outside `chip_smoke.py`.

    python3 tools/torch_mesh_graphs.py repro [--level LEVEL] [--runs N]
        [--no-release | --turns] [--halo all_reduce] [--deadline S]
        [--teardown explicit] [--keep-failed-capture] [--world N]
        [--device cuda|cpu] [--out DIR]
    python3 tools/torch_mesh_graphs.py cli [--world N] [--runs N]
        [--no-release] [--deadline S] [--out DIR]
    python3 tools/torch_mesh_graphs.py spatial [--world N]

`repro` runs one reproduction `--runs` times in a row, each in `--world`
fresh rank processes (NCCL, one a card, TF32 off) under one deadline
(`torch_ranks.spawn`: a rank still running shortly before it writes its
Python stack and its flight-recorder log and exits; each group's timeout is
half the time left, so an eager collective that waits on a hung peer writes
its log first). A run does two cases in one process pair, as the trainer's
users do when they build a second model in a process:

- `model`: `configs/male2female.yaml` at full width, 128^2, f32, two rows a
  rank, dis in then dis bn; each case a graphed model (an eager D+G
  iteration, one captured and replayed, one replayed) then its eager twin
  (`graphs=False`) on the third iteration's state;
- `tiny`: the same at gen / dis dim 8, mlp_dim 16, n_res 1, dis n_layer 2
  and 2 scales, 32^2;
- `micro`: no model: a body of a few all-reduces and a matmul through
  `StepGraphs` (eager, captured and replayed, replayed) then the same body
  eagerly; the second case a body of other sizes;
- `micro_group`, `micro_one`, `micro_both`: `micro` with the body's
  all-reduces on a second group of both ranks (`new_group([0, 1])`), plus
  one on a one-rank group a rank (each made on every rank, as a 1 x 2
  grid's data groups are), or alternating between the default group and
  the second one (as a 1 x 2 grid's step does);
- `micro_fail`, `micro_invalid`: `micro` with its capture failing after
  the body's all-reduces, the error going up through the teardown: a
  Python error, or an element set from a Python number (`t[0] = 0.0`, a
  copy from the host, which invalidates a capture); `--keep-failed-capture`
  takes out `StepGraphs`' destroy of a failed capture's graph;
- `p30_dp`, `p30_spatial`: phase 30's cases of `chip_smoke.py` run from
  this process as the script runs them (`chip_smoke._mesh_cases`, its
  snapshots made on this process's first card): the data-parallel pair
  (dis in, then dis bn), or one 1 x 2 spatial grid (dis bn), at full
  width, 128^2, f32, under a 150 s deadline.

Every rank destroys each case's graphs (`StepGraphs.release`) before the
next case and before its process group goes, as the trainer's callers do;
`--no-release` leaves them alive, dropped where Python drops them (a
reproduction of the hang in `destroy_process_group`), and `--turns`
alternates: runs 0, 2, 4, ... release, runs 1, 3, 5, ... do not. `--halo
all_reduce` sends a spatial grid's halos through their all-reduce form
(`p30_spatial`), which tells the point-to-point sends from the all-reduces.
`--teardown explicit` counts the live `CUDAGraph` objects and `StepGraphs`
entries, synchronizes and destroys each group by itself, a progress mark
before and after each. The ranks inherit the environment: run with
`TORCH_CPP_LOG_LEVEL=INFO` for c10d's teardown steps.
Each run's NCCL log (`NCCL_DEBUG=INFO`, subsystems INIT,REG,GRAPH), each
rank's stderr and dumps go to DIR/<level>.<run>/; one JSON line a run (its
`hung`: a rank dumped at the deadline) and a last line for the
reproduction go to stdout and DIR/results.jsonl. `--device cpu` runs
gloo ranks and the tests' stand-in graph: a rehearsal of the control flow.
Two reproductions run side by side on four cards as two commands, each with
its own `CUDA_VISIBLE_DEVICES` pair.

`cli` runs phase 24's train CLI under torchrun at `--world` ranks
(`chip_smoke.phase_ddp_cli`: male2female at full width, bf16, global batch
16, 30 iterations with grids and a snapshot, then `--resume` to 35, every
rank held to the cadence) `--runs` times in a row, one JSON line a run
(each run's failure, its ranks' stacks and collective logs among it, to
DIR/cli.<world>.<run>.txt); `--no-release` takes the CLI's release of its
graphs out. The numbers of the steps across ranks come from phase 30:
`python3 chip_smoke.py --mesh-graphs`; `spatial` runs its spatial step
alone on a 1 x `--world` grid (the split kernels' device time among it).

Import no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = os.path.join(tempfile.gettempdir(), "torch_mesh_graphs")  # --out's default
LEVELS = ("micro", "micro_group", "micro_one", "micro_both", "micro_fail", "micro_invalid",
          "tiny", "model")
MICRO_FAIL = {"micro_fail": "raise", "micro_invalid": "host_copy"}  # how their capture fails
# phase 30's cases (`chip_smoke._mesh_cases`: name, n_data, n_spatial, dis
# norm), run from this process as the script runs them, the snapshots made on
# the first card
CASE_LEVELS = {"p30_dp": (("dp_dis_in", 2, 1, "in"), ("dp_dis_bn", 2, 1, "bn")),
               "p30_spatial": (("spatial_1x2", 1, 2, "bn"),)}
DEADLINE = {"micro": 90.0, "micro_group": 40.0, "micro_one": 40.0, "micro_both": 40.0,
            "micro_fail": 40.0, "micro_invalid": 40.0,
            "tiny": 150.0, "model": 200.0, "p30_dp": 150.0,
            "p30_spatial": 150.0}


def _setup():
    sys.path.insert(0, str(ROOT))


def _nccl_log_env(run_dir: Path) -> dict:
    return {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,REG,GRAPH",
            "NCCL_DEBUG_FILE": str(run_dir / "nccl.%h.%p.log")}


# ------------------------------------------------------------------ the ranks
def _cfg(level: str, norm: str):
    import chip_smoke
    from aclgan_tpu_torch.config import load_config

    cfg = chip_smoke._variant_cfg(load_config(chip_smoke.CONFIG), 128 if level == "model" else 32,
                                  dis=dict(norm=norm))
    if level == "tiny":
        cfg = dataclasses.replace(
            cfg, gen=dataclasses.replace(cfg.gen, dim=8, mlp_dim=16, n_res=1),
            dis=dataclasses.replace(cfg.dis, dim=8, n_layer=2, num_scales=2))
    return cfg


def _graphs(device):
    """`StepGraphs` on a card; on the CPU (a rehearsal) its stand-in graph,
    which the trainer does not make there."""
    from aclgan_tpu_torch.graphs import StepGraphs

    if device.type == "cpu":
        from tests.torch_dp_worker import cpu_graphs

        return cpu_graphs()
    return StepGraphs(device)


def _model_case(level, norm, mesh, device, mark):
    """One case of `model` / `tiny`: the graphed model's three D+G iterations
    (eager, captured and replayed, replayed), then its eager twin on the
    third's state. Returns what the case keeps alive and the third
    iteration's metrics in both forms."""
    import copy

    import numpy as np
    import torch

    from aclgan_tpu_torch.parallel.mesh import batch_sharding, shard_state
    from aclgan_tpu_torch.trainer import ACLGAN

    cfg = _cfg(level, norm)
    size, b = cfg.data.crop_image_height, 2 * mesh.world
    rng = np.random.RandomState(8)
    x_a, x_b = (torch.from_numpy(rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8))
                for _ in range(2))
    zs = [{k: [rng.randn(b, cfg.gen.style_dim).astype(np.float32) for _ in range(3)]
           for k in ("dis", "gen")} for _ in range(3)]
    rows = batch_sharding(mesh, b)
    xa, xb = x_a[rows].to(device), x_b[rows].to(device)

    def build(graphs):
        m = ACLGAN(cfg, device=device, mesh=mesh, seed=1, graphs=graphs)
        if graphs and device.type == "cpu":
            m.graphs = _graphs(device)
        m.init_state()
        return m

    mark(f"dis {norm}: graphed model")
    model = build(True)
    shard_state(model, mesh)
    for i, z in enumerate(zs[:2]):
        mark(f"dis {norm}: iteration {i} ({'eager' if i == 0 else 'capture and replay'})")
        model.train_step(xa, xb, True, True, z=z)
    state = copy.deepcopy(model.snapshot())
    mark(f"dis {norm}: iteration 2 (replay)")
    graphed = {k: float(v) for k, v in model.train_step(xa, xb, True, True, z=zs[2]).items()}
    mark(f"dis {norm}: eager twin")
    twin = build(False)
    twin.restore(state)
    eager = {k: float(v) for k, v in twin.train_step(xa, xb, True, True, z=zs[2]).items()}
    mark(f"dis {norm}: eager twin done")
    return [model, twin], {"graphed": graphed, "eager": eager}


def _micro_groups(level, rank, world):
    """The groups a `micro*` level's body all-reduces over, in turn (None:
    the default group), and its one-rank group (`micro_one`), each made on
    every rank in the same order, as `make_mesh_2d` makes a grid's."""
    import torch.distributed as dist

    if level in ("micro", "micro_fail", "micro_invalid"):
        return [None], None
    every = dist.new_group(list(range(world)))
    if level == "micro_both":
        return [None, every], None
    ones = [dist.new_group([r]) for r in range(world)] if level == "micro_one" else None
    return [every], ones[rank] if ones else None


def _micro_case(name, groups, one, device, mark, fail=None):
    """One case of a `micro*` level: a body of all-reduces around a matmul
    (over `groups` in turn, plus one over the one-rank group `one` where
    given) through `StepGraphs` three times (eager, captured and replayed,
    replayed), then eagerly on the default stream. The capture's checks run
    on the default group. `fail` makes the capture fail after its
    all-reduces and lets the error go up through the rank's teardown, as a
    spatial step's failed capture did: "raise" (`micro_fail`) raises in
    Python (the capture itself ends well), "host_copy" (`micro_invalid`)
    sets an element from a Python float (`t[0] = 0.0`, a copy from the
    host, which invalidates the capture)."""
    import torch
    import torch.distributed as dist

    from aclgan_tpu_torch.parallel.mesh import make_mesh

    n, k = (256, 3) if name == "first" else (512, 5)
    gen = torch.Generator(device=device).manual_seed(3)
    w = torch.randn(n, n, device=device, generator=gen) / n ** 0.5
    x = torch.randn(8, n, device=device, generator=gen)

    def body(t):
        y = t @ w
        for i in range(k):
            s = y.sum(0)
            dist.all_reduce(s, group=groups[i % len(groups)])
            y = torch.tanh(y + 1e-3 * s)
        out = y.mean().reshape(1)
        dist.all_reduce(out, group=groups[-1])
        if one is not None:  # the identity over one rank
            dist.all_reduce(out, group=one)
        calls.append(1)
        if fail == "raise" and len(calls) == 2:  # the key's second call is its capture
            raise RuntimeError("micro_fail: an error inside the capture, after its all-reduces")
        if fail == "host_copy":
            real = torch.ones(2, device=device)
            real[0] = 0.0
            out = out * real.sum()
        return out

    calls = []

    mesh = make_mesh(-1)

    graphs = _graphs(device)
    for i in range(3):
        mark(f"{name}: call {i}")
        got = graphs.run(("micro", name), (x,), body, mesh=mesh)
    graphed = float(got)
    mark(f"{name}: eager twin")
    eager = float(body(x))
    mark(f"{name}: eager twin done")
    return [graphs], {"graphed": graphed, "eager": eager}


def _release(alive):
    """Destroy the graphs of what a case keeps alive (models, or `StepGraphs`)."""
    for obj in alive:
        obj.release() if hasattr(obj, "release") else obj.release_graphs()


def repro_rank(rank, world, port, level, out_dir, device_type, release=True,
               explicit_teardown=False, keep_failed=False):
    """Rank `rank` of one reproduction run: both cases, each case's graphs
    destroyed after it unless `release` is False, then its metrics to
    out_dir/result.<rank>.json; progress (one line a stage) to
    out_dir/progress.<rank>.txt. `explicit_teardown` destroys each group
    the level made by itself (the one-rank group, then the group of every
    rank, then the default one) after a synchronize, a mark before and after
    each. `keep_failed` takes out `StepGraphs`' destroy of a failed
    capture's graph (a reproduction of the hang it prevents)."""
    import torch
    import torch.distributed as dist

    from aclgan_tpu_torch.parallel.mesh import make_mesh
    from torch_ranks import init_rank

    progress = open(Path(out_dir) / f"progress.{rank}.txt", "a", buffering=1)

    def mark(msg):
        progress.write(f"{time.time():.3f} {msg}\n")

    if keep_failed:
        from aclgan_tpu_torch.graphs import StepGraphs

        StepGraphs._discard = lambda self, graph: None
    mark("init_process_group")
    device = init_rank(rank, world, port, device_type)
    alive, made = [], []
    try:
        micro = level.startswith("micro")
        if micro:
            groups, one = _micro_groups(level, rank, world)
            made = [("the one-rank group", one)] + [("the group of every rank", g)
                                                   for g in groups if g is not None]
        results = {}
        for case in (("first", "second") if micro else ("in", "bn")):
            if micro:
                alive, results[case] = _micro_case(case, groups, one, device, mark,
                                                   MICRO_FAIL.get(level))
            else:
                alive, results[case] = _model_case(level, case, make_mesh(-1), device, mark)
            if release:
                mark(f"{case}: release")
                _release(alive)
            alive = []  # without the release, freed at Python's next collection
        mark("done")
        with open(Path(out_dir) / f"result.{rank}.json", "w") as f:
            json.dump(results, f)
    finally:
        raised = sys.exc_info()[1]
        if raised is not None:
            mark(f"raised {type(raised).__name__}: {raised}")
        if release:
            _release(alive)
        if explicit_teardown:
            if device.type == "cuda":
                torch.cuda.synchronize()
            for what, group in made:
                if group is not None:
                    mark(f"destroy {what}")
                    dist.destroy_process_group(group)
                    mark(f"{what} destroyed")
        mark("destroy_process_group")
        dist.destroy_process_group()
        mark("destroyed")


# ------------------------------------------------------------------ running them
def _run_env(run_dir: Path) -> dict:
    """A run's environment: NCCL's log and each rank's stderr (c10d's log
    among it) in the run's directory."""
    from torch_ranks import RANK_STDERR

    return {**_nccl_log_env(run_dir), RANK_STDERR: str(run_dir)}


def run_repro(level: str, runs: int, deadline: float, out: Path, device_type: str = "cuda",
              world: int = 2, release="always", halo_p2p: bool = True,
              explicit_teardown: bool = False, keep_failed: bool = False) -> dict:
    """`runs` runs of one reproduction, each in `world` fresh rank processes
    under `deadline` (gloo ranks and the stand-in graph with `device_type`
    "cpu"), each rank's graphs destroyed before its group goes with
    `release` "always", never with "never", on even runs with "turns"; one
    JSON line a run. `explicit_teardown` destroys each group by itself with
    a mark before and after; `keep_failed` as `repro_rank`'s (the `micro*`
    levels). Returns the summary."""
    from torch_ranks import spawn

    outcomes = []
    for run in range(runs):
        released = release == "always" or (release == "turns" and run % 2 == 0)
        run_dir = out / f"{level}.{run}"
        run_dir.mkdir(parents=True, exist_ok=True)
        run_env = _run_env(run_dir)
        saved = {k: os.environ.get(k) for k in run_env}
        os.environ.update(run_env)
        t0 = time.time()
        error = None
        try:
            if level in CASE_LEVELS:
                _phase30_cases(level, run_dir, deadline, device_type, released, halo_p2p,
                               explicit_teardown)
            else:
                spawn(repro_rank, world, (level, str(run_dir), device_type, released,
                                          explicit_teardown, keep_failed),
                      timeout=deadline, dump_dir=run_dir)
        except (RuntimeError, AssertionError) as e:
            error = f"{type(e).__name__}: {e}"
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        stages = {}
        for r in range(world):
            p = run_dir / f"progress.{r}.txt"
            lines = p.read_text().splitlines() if p.exists() else []
            stages[r] = lines[-1].split(" ", 1)[1] if lines else "(not started)"
        line = {"level": level, "world": world, "run": run, "release": released,
                "halo": "point_to_point" if halo_p2p else "all_reduce",
                "teardown": "explicit" if explicit_teardown else "destroy_process_group",
                "ok": error is None,
                # a rank dumped at the deadline (faulthandler's "Timeout" header)
                "hung": any(p.read_text(errors="replace").startswith("Timeout (")
                            for p in run_dir.rglob("stack.*.txt")),
                "seconds": round(time.time() - t0, 1), "last_stage": stages}
        if error is not None:
            (run_dir / "error.txt").write_text(error)
            line["error_head"] = error[:400]
            line["stacks_in_destroy"] = sorted(
                p.name for p in run_dir.rglob("stack.*.txt")
                if "destroy_process_group" in p.read_text(errors="replace"))
        elif level not in CASE_LEVELS:
            line["graphed_vs_eager"] = _digest(
                [json.loads((run_dir / f"result.{r}.json").read_text()) for r in range(world)])
        outcomes.append(line)
        print(json.dumps(line), flush=True)
        with open(out / "results.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
    return {"level": level, "world": world, "runs": len(outcomes),
            **{f"ok with release {r}": [o["ok"] for o in outcomes if o["release"] == r]
               for r in (True, False)}}


def _phase30_cases(level, run_dir, deadline, device_type, release, halo_p2p,
                   explicit_teardown=False):
    """`chip_smoke._mesh_cases` for the cases of `level`, from this process.
    Its snapshots and the ranks' states (full width: hundreds of MB) go to a
    temporary directory, never under `run_dir`, so that a run cut from
    outside leaves nothing large in an output directory; the ranks' dumps
    are moved to run_dir/dumps after it."""
    import shutil

    import chip_smoke
    from aclgan_tpu_torch.config import load_config

    rank_opts = (release, halo_p2p, explicit_teardown)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            chip_smoke._mesh_cases(load_config(chip_smoke.CONFIG), tmp, device_type,
                                   CASE_LEVELS[level], deadline, rank_opts)
        finally:
            cases = Path(tmp) / "mesh_cases"
            for p in [*cases.glob("progress.*.txt"), cases / "dumps"]:
                if p.exists():
                    shutil.move(str(p), str(run_dir / p.name))


def _digest(results):
    """The largest relative gap between a case's replayed and eager metrics,
    over the ranks."""
    out = {}
    for res in results:
        for case, r in res.items():
            g, e = r["graphed"], r["eager"]
            pairs = [(g[k], e[k]) for k in g] if isinstance(g, dict) else [(g, e)]
            gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in pairs)
            out[case] = max(out.get(case, 0.0), gap)
    return out


def run_cli(world: int, runs: int, out: Path, release: bool = True,
            deadline: float = None) -> dict:
    """Phase 24's train CLI under torchrun at `world` ranks (`chip_smoke.
    phase_ddp_cli`) `runs` times in a row; one JSON line a run, a failure's
    text (every rank's stack and collective log among it) to
    out/cli.<world>.<run>.txt. Returns the summary."""
    import chip_smoke
    from aclgan_tpu_torch.config import load_config

    cfg = load_config(chip_smoke.CONFIG)
    outcomes = []
    for run in range(runs):
        t0 = time.time()
        line = {"cli_world": world, "run": run, "release": release}
        with tempfile.TemporaryDirectory() as tmp:
            try:
                got = chip_smoke.phase_ddp_cli(cfg, tmp, None, world, release,
                                               deadline=deadline or chip_smoke.DDP_DEADLINE)
                line.update(ok=True, per_it=round(got["per_it"], 4),
                            p50={k: round(v, 4) for k, v in got["p50"].items()},
                            launches=got["launches"], replayed=got["replayed"],
                            first_s=round(got["first_s"], 1), resume_s=round(got["resume_s"], 1))
            except (RuntimeError, AssertionError) as e:
                text = f"{type(e).__name__}: {e}"
                (out / f"cli.{world}.{run}.txt").write_text(text)
                line.update(ok=False, error_head=text[:400],
                            stacks_in_destroy=text.count("destroy_process_group"))
        line["seconds"] = round(time.time() - t0, 1)
        outcomes.append(line)
        print(json.dumps(line), flush=True)
        with open(out / "results.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
    return {"cli_world": world, "runs": runs, "release": release,
            "ok": [o["ok"] for o in outcomes]}


def run_spatial(world: int) -> dict:
    """Phase 30's spatial step alone: phase 27's cut (f32, 512^2, global
    batch 2) on a 1 x `world` NCCL grid, graphed then eager
    (`chip_smoke._job_bare` in one spawn); one JSON line a form with its s
    an iteration, host s, idle share, peak and the split kernels' device ms
    and events over a traced D+G + D. Returns them."""
    import chip_smoke
    from aclgan_tpu_torch.config import load_config

    cut = chip_smoke._spatial_cut(load_config(chip_smoke.CONFIG))
    with tempfile.TemporaryDirectory() as tmp:
        ranks, secs = chip_smoke._mesh_spawn(
            world, [(f, (cut, chip_smoke.SP_BATCH, f == "graphed", world))
                    for f in ("graphed", "eager")], tmp, "spatial")
    out = {}
    for form, r in ranks[0].items():
        out[form] = {k: r[k] for k in ("s", "host_s", "idle", "peak", "launches", "split_ms")}
        print(json.dumps({"spatial_world": world, "form": form, **out[form]}), flush=True)
    return {"spatial_world": world, "seconds": round(secs, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("repro")
    r.add_argument("--level", choices=LEVELS + tuple(CASE_LEVELS), default="micro")
    r.add_argument("--runs", type=int, default=1)
    r.add_argument("--deadline", type=float, default=None)
    r.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    r.add_argument("--world", type=int, default=2)
    r.add_argument("--halo", choices=("point_to_point", "all_reduce"), default="point_to_point")
    r.add_argument("--teardown", choices=("destroy_process_group", "explicit"),
                   default="destroy_process_group")
    r.add_argument("--keep-failed-capture", dest="keep_failed", action="store_true")
    keep = r.add_mutually_exclusive_group()
    keep.add_argument("--no-release", dest="release", action="store_const", const="never",
                      default="always")
    keep.add_argument("--turns", dest="release", action="store_const", const="turns")
    c = sub.add_parser("cli")
    c.add_argument("--world", type=int, default=2)
    c.add_argument("--runs", type=int, default=1)
    c.add_argument("--deadline", type=float, default=None)
    c.add_argument("--no-release", dest="release", action="store_false")
    sp = sub.add_parser("spatial")
    sp.add_argument("--world", type=int, default=2)
    for p in (r, c, sp):
        p.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    _setup()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    import torch

    device = getattr(args, "device", "cuda")
    if device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"torch_mesh_graphs: needs {args.world} CUDA devices", file=sys.stderr)
        return 2
    if device == "cuda":  # once, before any rank loads them
        from aclgan_tpu_torch.ops.kernels import build

        build.build_all(sorted(p.name for p in build.CSRC.glob("*.cu")))
    if args.cmd == "cli":
        summary = run_cli(args.world, args.runs, out, args.release, args.deadline)
    elif args.cmd == "spatial":
        summary = run_spatial(args.world)
    else:
        summary = run_repro(args.level, args.runs, args.deadline or DEADLINE[args.level], out,
                            device, args.world, args.release, args.halo == "point_to_point",
                            args.teardown == "explicit", args.keep_failed)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
