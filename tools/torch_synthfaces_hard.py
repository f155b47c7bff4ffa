#!/usr/bin/env python3
"""The synthfaces_hard acceptance run of the PyTorch/CUDA port, end to end,
held against the JAX package's recorded run (`docs/run_synthfaces_hard/`).

    python3 tools/torch_synthfaces_hard.py [STAGE] --work DIR [--iters N]
        [--device cuda|cpu] [--smoke] [--data_root DIR] [--inception_weights PT]
        [--recorded DIR] [--alongside | --score_after] [--deadline S] [--world N]
        [--score_on CARDS] [--scorer_threads T] [--docs DIR]

STAGE is one of `dataset`, `train`, `inception`, `curves`, `calibrate`,
`report` or `all` (the default: every stage in that order), or `recover`,
which rebuilds the curve files of a call cut before it copied them out from
the rows its `follow` logs hold, for `report`. Each stage runs
the port's own entry point and skips what DIR already holds, so a cut run
resumes where it stopped:

- `dataset`: `tools/make_dataset.py --style hard --n 2000 --n_test 500
  --size 286` (the config's header) into DIR/data, in a subprocess;
- `train`: `aclgan_tpu_torch.cli.train.main` in process on a copy of
  `configs/synthfaces_hard.yaml` in DIR whose only change is `data_root`
  (a copy that differs in any other key is refused), to `--iters`
  iterations, with `--resume` from the newest complete snapshot set. It
  records the CLI's `Iteration:` seconds, the process's VmRSS (every 30 s and
  at each `Iteration:` line), the peak device memory, the K1 / K2 launches
  (the counters of `ops/kernels/instance_norm.py`) beside the count the D1/G2
  cadence gives, the EMA generators' rel-L2 from the live ones at each
  snapshot, and the non-finite values of `scalars.jsonl`, in
  DIR/train_log.json. With `--deadline S`, the first `Iteration:` line
  after a snapshot ends the CLI when the next snapshot would land more than
  S seconds after the command started (the segment's `stopped_at`). With
  `--world N` (N > 1) the CLI runs on N ranks under the torchrun launcher
  (`torch_ranks.torchrun`, one deadline that dumps every rank), one a card
  (NCCL; gloo with `--device cpu`), each on batch_size / N of the global
  batch in the config's data-parallel mesh (`tpu.mesh_data` -1): each rank
  (`train_rank`) records its launches, steps, samples, peak memory, VmRSS
  and the seconds it waited on its feed, rank 0 also the `Iteration:` lines
  and the EMA's distance, and the segment gets one entry per rank. The
  deadline's decision is rank 0's, shared by one broadcast at the first
  iteration after that line, so every rank stops at the same iteration;
- `inception`: `cli.train_inception.main` at the JAX tool's defaults (300
  steps, batch 32, 149^2, seed 0); its full-set accuracy to DIR/inception.json;
- `curves`: `cli.fid_curve.main` with `--n 500 --styles 3 --bootstrap 100`,
  `--prefix gen` then `--prefix ema`, continued with `--start_after` where
  the curve file already holds rows under the same protocol;
- `calibrate`: under the same classifier and n, FID(testA, testB) (the
  domain gap) and FID(first n of trainB, testB) (the estimator's floor),
  float64 scipy as the curves', and the classifier's target-domain (B)
  rate on real testB and on real testA;
- `report`: both curves beside the recorded ones at the common iterations
  (`tools/fid_compare.compare`, which refuses another protocol), gen
  against ema, the classifier's gate (real testB rated B, real testA not:
  a failed gate voids every quality bar), the quality bars and the EMA's
  two rules (`BARS`), the
  EMA's wins in the rules' window, the run's rates and checks (VmRSS at
  each 1,000 iterations and its slope from 500 on, per segment), and a
  test grid of the selected snapshot shrunk by 3, written with both curves
  and `summary.json` to `--docs` (default `docs/run_synthfaces_hard_torch`;
  DIR/docs under `--smoke`).

`all --alongside` runs `dataset`, then `train` (in this process, or its
ranks under `--world N`) while a second process (`follow`, its OpenMP /
BLAS threads capped at `--scorer_threads`) fine-tunes the classifier,
calibrates and scores each snapshot as it lands; then `report`. With
`--score_on CARDS` (a card, or two: then one `follow` a family, the first
training the classifier) each `follow` sees only its card. The snapshots
still unscored when training ends and the seconds scoring ran on after it
go to DIR/alongside.json.

`all --score_after --score_on C1,...,CN` runs `dataset`, then `train` while
one process (`classifier`, on CN) fine-tunes the classifier and
calibrates and scores nothing, then, once training has ended, N scorers
(`score`, one a listed card, each seeing only that card; a card listed twice
gets two), then `report`. The snapshots of both families are split among
the scorers interleaved (`score_split`: the k-th takes every N-th
family-snapshot in iteration order, from the k-th on). Each scorer runs one
`cli.fid_curve` sweep a family over a run directory (DIR/score/<k>) whose
`checkpoints/` hard-links its share; its curve files there are its part files,
which `cli.fid_curve` rewrites after every row. The parent merges the parts
into DIR's curve files as each scorer ends (`merge_parts`, which refuses a
part of another protocol), and so does `recover`, so a call cut while
scoring keeps every row scored. DIR/alongside.json holds the placement, the
backlog when training ended, each scorer's seconds and the seconds from the
end of training to the last row; it is written when training ends and
when each scorer ends. A rerun scores only what no curve or part holds.

`train_rank` also reads its process's CPU seconds (its loader threads
included) each `log_iter` iterations, and `report` prints them a second of
each 1,000 iterations beside each rank's feed-wait share.

`report` compares with `--recorded` (default `docs/run_synthfaces_hard`).
`--smoke` shrinks every size (64 images a domain, a 40-step classifier, 40
iterations with snapshots every 20, curves at n 64 with 2 styles and 20
resamples), writes the docs under DIR and compares with no recorded run
unless `--recorded` names one (which then refuses: another n). `--data_root` and
`--inception_weights` take an existing dataset and classifier in place of
the first and third stages. `--device` defaults to cuda and raises without
a card; `cpu` runs everything on the CPU (at `--smoke` sizes and a few
`--iters`). Imports nothing of JAX or of `aclgan_tpu`; the launch counts
of the port's generators come from `chip_smoke.py`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple
from unittest import mock

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from aclgan_tpu_torch.config import Config, load_config, save_config  # noqa: E402
from aclgan_tpu_torch.utils.hostmem import RssSampler, rss_slope  # noqa: E402

STEM = "synthfaces_hard"
SHIPPED = REPO / "configs" / f"{STEM}.yaml"
RECORDED = REPO / "docs" / "run_synthfaces_hard"
DOCS = REPO / "docs" / "run_synthfaces_hard_torch"
STAGES = ("dataset", "train", "inception", "curves", "calibrate", "report")
RECOVER = "recover"  # not in `all`: for a work directory a cut call left
PREFIXES = ("gen", "ema")

# The quality bars, set before the run (the JAX run's reading in brackets):
# the classifier's full-set accuracy [1.0]; the target-domain rate at every
# snapshot from 2,000 on, both families [1.0]; FID(ema@1000) above
# FID(gen@1000), the EMA warm-up [32.865 against 5.611]; the best FID of
# both families at most a quarter of the domain gap under the same classifier.
# The EMA's two rules over the snapshots from 10,000 to 20,000: its FID range
# (max - min) narrower than the live weights' [2.889 against 32.838], and its
# median FID at most 1.5x the live weights' [14.804 / 11.689 = 1.266].
# The classifier's gate, which every quality verdict needs: real testB rated
# as B at a rate of at least 0.99, real testA at most 0.01 (at the curve's n,
# loaded as the curves load their real side); otherwise no bar is read.
BARS = {"accuracy_min": 0.99, "rate_min": 0.99, "rate_from": 2000,
        "warmup_iteration": 1000, "best_over_gap_max": 0.25,
        "ema_window": (10000, 20000), "ema_median_over_live_max": 1.5,
        "real_b_as_b_min": 0.99, "real_a_as_b_max": 0.01}
GATE_FAILED = "classifier failed its gate"
RSS_GROWTH_MAX = 0.5 * 2**30   # bytes from iteration 500 to the end of a segment


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every size of one run: the dataset, the classifier, training, curves."""

    n: int = 2000                # train images a domain
    n_test: int = 500
    size: int = 286
    inception_steps: int = 300
    inception_batch: int = 32
    inception_size: int = 149
    inception_seed: int = 0
    iters: int = 3000
    curve_n: int = 500
    styles: int = 3
    bootstrap: int = 100
    config: Tuple[Tuple[str, Any], ...] = ()  # top-level config keys changed


FULL = Sizes()
SMOKE = Sizes(n=64, n_test=64, inception_steps=40, iters=40, curve_n=64, styles=2,
              bootstrap=20, config=(("snapshot_save_iter", 20), ("log_iter", 10),
                                    ("image_save_iter", 40), ("image_display_iter", 40)))


def _fid_compare():
    """`tools/fid_compare.py`, the JAX package's curve comparison (json only)."""
    spec = importlib.util.spec_from_file_location("fid_compare",
                                                  REPO / "tools" / "fid_compare.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------------ layout
@dataclasses.dataclass(frozen=True)
class Work:
    """The files of one run under its work directory."""

    root: Path
    data_root: Path
    inception: Path

    @classmethod
    def at(cls, root, data_root=None, inception=None) -> "Work":
        root = Path(root).resolve()
        return cls(root, Path(data_root).resolve() if data_root else root / "data",
                   Path(inception).resolve() if inception else root / "inception.pt")

    @property
    def config(self) -> Path:
        return self.root / f"{STEM}.yaml"

    @property
    def output_path(self) -> Path:
        return self.root / "run"

    @property
    def run_dir(self) -> Path:
        return self.output_path / "outputs" / STEM

    @property
    def checkpoints(self) -> Path:
        return self.run_dir / "checkpoints"

    @property
    def scalars(self) -> Path:
        return self.output_path / "logs" / STEM / "scalars.jsonl"

    def curve(self, prefix: str) -> Path:
        return self.run_dir / f"fid_curve_{prefix}.json"

    def scorer_dir(self, k: int) -> Path:
        """The run directory of `all --score_after`'s k-th scorer: its share's
        snapshots under checkpoints/, its part curve files beside them."""
        return self.root / "score" / str(k)

    def parts(self, prefix: str) -> List[Path]:
        return sorted(self.root.glob(f"score/*/fid_curve_{prefix}.json"))

    @property
    def train_done(self) -> Path:
        """Written when a train stage run beside `follow` has ended."""
        return self.root / "train.done"

    def log(self, name: str) -> Path:
        return self.root / f"{name}.json"


def _read(path: Path, default=None):
    if not Path(path).exists():
        return default
    return json.loads(Path(path).read_text())


def _write(path: Path, doc) -> None:
    tmp = Path(f"{path}.tmp")
    tmp.write_text(json.dumps(doc, indent=1))
    os.replace(tmp, path)


def _relative(doc):
    """`doc` with the checkout's absolute paths made relative to it."""
    return json.loads(json.dumps(doc).replace(str(REPO) + os.sep, ""))


# ------------------------------------------------------------------ config guard
def _flat(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def derived_config(data_root, sizes: Sizes) -> Config:
    """The shipped config with `data_root` (and the sizes' own changes)."""
    cfg = load_config(SHIPPED)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_root=str(data_root)),
                              **dict(sizes.config))
    return cfg


def check_config(cfg: Config, sizes: Sizes) -> None:
    """Refuse a config that differs from the shipped one in any key but
    `data.data_root` and the sizes' own changes."""
    allowed = {"data.data_root"} | {k for k, _ in sizes.config}
    want = _flat(dataclasses.replace(load_config(SHIPPED), **dict(sizes.config)).to_dict())
    got = _flat(cfg.to_dict())
    diff = sorted(k for k in set(want) | set(got)
                  if k not in allowed and repr(want.get(k)) != repr(got.get(k)))
    if diff:
        raise ValueError(f"the config differs from {SHIPPED.name} in "
                         + ", ".join(f"{k}: {got.get(k)!r} (shipped {want.get(k)!r})"
                                     for k in diff))


def ensure_config(work: Work, sizes: Sizes) -> Config:
    """The run's config in the work directory (written the first time),
    checked against the shipped one."""
    if work.config.exists():
        cfg = load_config(work.config)
        check_config(cfg, sizes)
        if Path(cfg.data.data_root).resolve() != work.data_root:
            raise ValueError(f"{work.config} reads data from {cfg.data.data_root}, not "
                             f"{work.data_root}")
        return cfg
    cfg = derived_config(work.data_root, sizes)
    check_config(cfg, sizes)
    work.root.mkdir(parents=True, exist_ok=True)
    save_config(cfg, work.config)
    return cfg


# ------------------------------------------------------------------ planners
def snapshot_stamps(ckpt_dir: Path, prefix: str) -> List[int]:
    """The iterations of the `<prefix>_%08d.pt` files in `ckpt_dir`."""
    if not Path(ckpt_dir).is_dir():
        return []
    out = []
    for p in Path(ckpt_dir).iterdir():
        m = re.fullmatch(rf"{prefix}_(\d{{8}})\.pt", p.name)
        if m and p.is_file():
            out.append(int(m[1]))
    return sorted(out)


def train_plan(ckpt_dir: Path, iters: int) -> Optional[int]:
    """Where training starts: None when a snapshot set at `iters` or later
    exists, else the newest complete set's iteration (gen, dis and ema files
    and `optimizer.pt`; 0 = a fresh run). A generator file newer than that
    set is a torn set, which the CLI would refuse: raise naming it."""
    gens = snapshot_stamps(ckpt_dir, "gen")
    complete = sorted(set(gens) & set(snapshot_stamps(ckpt_dir, "dis"))
                      & set(snapshot_stamps(ckpt_dir, "ema")))
    if not (Path(ckpt_dir) / "optimizer.pt").exists():
        complete = []
    newest = complete[-1] if complete else 0
    torn = [s for s in gens if s > newest]
    if torn:
        raise RuntimeError(f"{ckpt_dir}: gen_{torn[-1]:08d}.pt has no complete snapshot set "
                           "(dis, ema, optimizer.pt); move the newer files away to resume "
                           f"from {newest}")
    return None if newest >= iters else newest


def curve_meta(sizes: Sizes, prefix: str) -> Dict[str, Any]:
    """The protocol keys `cli.fid_curve` writes, for these sizes."""
    from aclgan_tpu_torch.cli.fid_curve import CI_METHOD, PROTOCOL

    return {"n": sizes.curve_n, "styles": sizes.styles, "bootstrap": sizes.bootstrap,
            "prefix": prefix, "protocol": PROTOCOL,
            "ci": CI_METHOD if sizes.bootstrap else None}


def curve_plan(doc: Optional[Dict[str, Any]], stamps: List[int],
               meta: Dict[str, Any]) -> Optional[int]:
    """None when the curve file already holds a row for every snapshot, else
    the `--start_after` of the sweep (0 = from the first snapshot). A file
    written under another protocol is refused, not overwritten."""
    if not stamps:
        raise RuntimeError(f"no {meta['prefix']} snapshots to score")
    if doc is None:
        return 0
    got = {k: doc.get(k) for k in meta}
    if got != meta:
        raise ValueError(f"the {meta['prefix']} curve on disk was taken under another "
                         f"protocol: {got} against {meta}")
    done = {r["iteration"] for r in doc.get("rows", [])}
    if set(stamps) <= done:
        return None
    return max(done, default=0)


def score_split(stamps: Dict[str, List[int]], n: int) -> List[List[Tuple[str, int]]]:
    """The shares of `n` scorers: the family-snapshots in iteration order
    (gen before ema at one iteration), the k-th scorer taking every n-th
    from the k-th on, so a cut call leaves its missing rows spread over
    the curve."""
    items = sorted(((it, PREFIXES.index(p)) for p in PREFIXES for it in stamps.get(p, [])))
    return [[(PREFIXES[f], it) for it, f in items[k::n]] for k in range(n)]


def cadence_counts(start: int, end: int, epoch_len: int, cfg: Config,
                   rank: int = 0) -> Dict[str, int]:
    """What the train CLI runs on rank `rank` over global iterations
    start+1..end of one call (the cadence is epoch-local and restarts with
    the call): D+G and D-only iterations, G steps, display samples (two test
    grids and a train grid; rank 0 alone samples) and the K1 / K2 launches
    they make."""
    cadence = chip_smoke._cadence(cfg, epoch_len, start + 1, end)
    samples = 0 if rank else sum(2 * (i % cfg.image_save_iter == 0)
                                 + (i % cfg.image_display_iter == 0) for i in cadence)
    k1, k2 = chip_smoke._expected_launches(cadence, samples)
    return {"dg": sum(d and g for d, g in cadence.values()),
            "d_only": sum(d and not g for d, g in cadence.values()),
            "g_steps": sum(g for _, g in cadence.values()), "samples": samples,
            "k1": k1, "k2": k2}


# ------------------------------------------------------------------ measurement
class _Tee(io.TextIOBase):
    """Passes writes on to `out` and hands each complete line to `on_line`."""

    def __init__(self, out, on_line: Callable[[str], None]):
        self.out, self.on_line, self.buf = out, on_line, ""

    def write(self, s):
        self.out.write(s)
        self.buf += s
        *lines, self.buf = self.buf.split("\n")
        for line in lines:
            self.on_line(line)
        return len(s)

    def flush(self):
        self.out.flush()


class Stopped(Exception):
    """Raised from the CLI's `Iteration:` line to end a train call at its
    deadline; `iteration` is the last iteration the call ran."""

    def __init__(self, iteration: int):
        super().__init__(f"stopped at iteration {iteration}")
        self.iteration = iteration


SNAPSHOT_SECONDS = 30.0  # time allowed to write one full-width snapshot set


class _Recorder(RssSampler):
    """The `Iteration:` lines of a train call and this process's VmRSS
    (every `every` seconds, and at each such line). With `stop_by` (a
    `time.time()`), the first line after each snapshot raises `Stopped` when
    the next snapshot would land later than that at the recent rate; with
    `raise_on_stop` False it keeps that line's iteration in `stop_at`
    instead, for the ranks to share."""

    def __init__(self, start: int = 0, every: float = 30.0, stop_by: Optional[float] = None,
                 snapshot_every: int = 1000, log_iter: int = 100, raise_on_stop: bool = True):
        super().__init__(every=every, start=start)
        self.lines: List[Tuple[int, float]] = []
        self.stop_by, self.snapshot_every, self.log_iter = stop_by, snapshot_every, log_iter
        self.raise_on_stop, self.stop_at = raise_on_stop, None

    def on_line(self, line: str):
        m = chip_smoke._ITERATION.match(line)
        if m:
            self.iteration = int(m[1])
            self.lines.append((self.iteration, float(m[2])))
            self.sample()
            if self.stop_by is not None and self._out_of_time():
                if self.raise_on_stop:
                    raise Stopped(self.iteration)
                self.stop_at = self.iteration

    def _out_of_time(self) -> bool:
        if self.iteration % self.snapshot_every != self.log_iter % self.snapshot_every:
            return False  # not the first line after a snapshot
        s_per_it = float(np.median([secs for _, secs in self.lines[-10:]])) / self.log_iter
        left = (self.snapshot_every - self.log_iter) * s_per_it + SNAPSHOT_SECONDS
        return time.time() + left > self.stop_by


def _launches():
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    return K.launches, K.bwd_launches


def process_cpu_seconds() -> float:
    """This process's user + system CPU seconds, every thread's (the data
    loader's workers are threads) included."""
    t = os.times()
    return t.user + t.system


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _count_images(folder: Path) -> int:
    from aclgan_tpu_torch.data.dataset import is_image_file

    return sum(map(is_image_file, os.listdir(folder))) if folder.is_dir() else 0


# ------------------------------------------------------------------ stages
def run_dataset(argv: List[str]) -> None:
    """`tools/make_dataset.py` in a subprocess (numpy and Pillow only)."""
    out = subprocess.run([sys.executable, str(REPO / "tools" / "make_dataset.py"), *argv],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"make_dataset.py failed ({out.returncode}): {out.stderr[-2000:]}")


def stage_dataset(work: Work, sizes: Sizes, args) -> Dict[str, Any]:
    want = {"trainA": sizes.n, "trainB": sizes.n, "testA": sizes.n_test, "testB": sizes.n_test}
    got = {d: _count_images(work.data_root / d) for d in want}
    if all(got[d] >= want[d] for d in want):
        return {"skipped": True, "images": got}
    if args.data_root:
        raise RuntimeError(f"--data_root {work.data_root} holds {got}, fewer than {want}")
    t0 = time.time()
    run_dataset(["--out", str(work.data_root), "--style", "hard", "--n", str(sizes.n),
                 "--n_test", str(sizes.n_test), "--size", str(sizes.size)])
    got = {d: _count_images(work.data_root / d) for d in want}
    if got != want:
        raise RuntimeError(f"make_dataset.py wrote {got}, expected {want}")
    return {"skipped": False, "images": got, "seconds": time.time() - t0}


def stage_train(work: Work, sizes: Sizes, args) -> Dict[str, Any]:
    from aclgan_tpu_torch.cli import train as cli_train

    cfg = ensure_config(work, sizes)
    start = train_plan(work.checkpoints, args.iters)
    if start is None:
        return {"skipped": True}
    argv = ["--config", str(work.config), "--output_path", str(work.output_path),
            "--max_iter", str(args.iters), "--device", args.device]
    if start:
        argv.append("--resume")
    if args.world > 1:
        return _append_segment(work, train_ranks(work, cfg, start, argv, args))
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    k0 = _launches()
    t0 = time.time()
    stopped = None
    distance: Dict[str, Dict[str, float]] = {}
    save = cli_train.save_checkpoint

    def save_and_measure(directory, model, iterations, **kw):
        save(directory, model, iterations, **kw)
        if model.ema is not None:
            distance[str(iterations + 1)] = ema_distance(model)

    with _Recorder(start, stop_by=args.stop_by, snapshot_every=cfg.snapshot_save_iter,
                   log_iter=cfg.log_iter) as rec:
        tee = _Tee(sys.stdout, rec.on_line)
        try:
            with contextlib.redirect_stdout(tee), \
                    mock.patch.object(cli_train, "save_checkpoint", save_and_measure):
                cli_train.main(argv)
        except Stopped as e:
            stopped = e.iteration
            print(f"[{STEM}] train stopped at iteration {stopped}: the next snapshot would "
                  "land after the deadline", flush=True)
        _sync(device)
    k1, k2 = (b - a for a, b in zip(k0, _launches()))
    epoch_len = min(_count_images(work.data_root / "trainA"),
                    _count_images(work.data_root / "trainB")) // cfg.batch_size
    end = args.iters if stopped is None else stopped
    segment = {
        "start": start, "end": end, "stopped_at": stopped, "argv": argv,
        "seconds": time.time() - t0,
        "device": args.device, "iteration_lines": rec.lines, "log_iter": cfg.log_iter,
        "rss": rec.rss, "peak_memory": (torch.cuda.max_memory_allocated()
                                        if device.type == "cuda" else None),
        "launches": {"k1": k1, "k2": k2}, "ema_from_live_rel_l2": distance,
        "derived": cadence_counts(start, end, epoch_len, cfg),
        "epoch_len": epoch_len,
    }
    return _append_segment(work, segment)


def _append_segment(work: Work, segment: Dict[str, Any]) -> Dict[str, Any]:
    log = _read(work.log("train_log"), {"segments": []})
    log["segments"].append(segment)
    _write(work.log("train_log"), log)
    return segment


# ------------------------------------------------------------------ ranks
RANK_ENTRY = "--train-rank"  # this tool's own argument: one rank of a `--world N` train stage
RANK_GRACE = 180.0           # s past `--deadline` before the launcher's deadline dumps the ranks
RANK_TIMEOUT = 12 * 3600.0   # s: the launcher's deadline of a run without `--deadline`


def train_ranks(work: Work, cfg: Config, start: int, argv: List[str], args) -> Dict[str, Any]:
    """The train CLI on `args.world` ranks under the torchrun launcher, each
    a `train_rank` (`torch_ranks.torchrun`: one deadline, every rank's
    stack and collective log dumped near it); returns the segment: rank 0's
    lines, VmRSS, peak memory, launches and EMA distances at its top level
    as a single process's, and `ranks`, one entry a rank."""
    import torch_ranks

    spec = work.root / "train_rank.json"
    _write(spec, {"argv": argv, "start": start, "stop_by": args.stop_by,
                  "out": str(work.root / "train_rank")})
    for r in range(args.world):
        Path(f"{work.root / 'train_rank'}.{r}.json").unlink(missing_ok=True)
    timeout = RANK_TIMEOUT if args.stop_by is None else args.stop_by - time.time() + RANK_GRACE
    t0 = time.time()
    lines, _ = torch_ranks.torchrun([Path(__file__).resolve(), RANK_ENTRY, spec], args.world,
                                    timeout, work.root / "dumps",
                                    {"PYTHONPATH": os.pathsep.join(
                                        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                                       if p])})
    print("\n".join(lines), flush=True)
    ranks = [_read(Path(f"{work.root / 'train_rank'}.{r}.json")) for r in range(args.world)]
    ends = {r["end"] for r in ranks}
    if len(ends) != 1:
        raise RuntimeError(f"the {args.world} ranks ended at iterations {sorted(ends)}")
    end = ends.pop()
    epoch_len = min(_count_images(work.data_root / "trainA"),
                    _count_images(work.data_root / "trainB")) // (cfg.batch_size // args.world)
    for r in ranks:
        r["derived"] = cadence_counts(start, end, epoch_len, cfg, r["rank"])
    lead = ranks[0]
    if lead["stopped_at"] is not None:
        print(f"[{STEM}] train stopped at iteration {end} on every rank: the next snapshot "
              "would land after the deadline", flush=True)
    return {"start": start, "end": end, "stopped_at": lead["stopped_at"], "argv": argv,
            "seconds": time.time() - t0, "device": args.device, "world": args.world,
            "iteration_lines": lead["lines"], "log_iter": cfg.log_iter, "rss": lead["rss"],
            "peak_memory": lead["peak_memory"], "launches": lead["launches"],
            "ema_from_live_rel_l2": lead["ema_from_live_rel_l2"], "derived": lead["derived"],
            "epoch_len": epoch_len, "ranks": ranks}


def _timed_feed(prefetch, waited: List[float]):
    """`prefetch` (the CLI's `device_prefetch`) adding the seconds each `next`
    waited for its batch to waited[0]."""
    def timed(*args, **kwargs):
        batches = prefetch(*args, **kwargs)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    x = next(batches)
                except StopIteration:
                    return
                waited[0] += time.perf_counter() - t0
                yield x
        finally:
            batches.close()

    return timed


def train_rank(spec_path: str) -> None:
    """One rank of a `--world N` train stage, as `train_ranks` starts it
    under torchrun: armed to dump near the launcher's deadline, it joins
    the group from torchrun's environment (NCCL on cuda:LOCAL_RANK; gloo on
    the CPU), which puts the CLI in the config's data-parallel mesh without
    a changed key, and runs `cli.train.main` on its card. It counts its
    D+G and D-only steps, its `sample` calls, the K1 / K2 launches, the
    seconds its feed kept it waiting and its process's CPU seconds (both
    at the start and every `log_iter` iterations), its VmRSS (rank 0 at each `Iteration:` line, the others
    every `log_iter` iterations) and its peak device memory; rank 0 also the lines and the
    EMA's rel-L2 from the live weights at each snapshot. Under a deadline,
    at the first iteration after each line that follows a snapshot every
    rank takes rank 0's decision by one broadcast and all stop there
    together. Writes <out>.<rank>.json, then destroys its graphs and the
    group (`torch_ranks.teardown`)."""
    import torch.distributed as dist

    import torch_ranks
    from aclgan_tpu_torch.cli import train as cli_train
    from aclgan_tpu_torch.parallel.mesh import init_distributed
    from aclgan_tpu_torch.trainer import ACLGAN

    torch_ranks.watch_torchrun_rank()
    spec = _read(Path(spec_path))
    argv = list(spec["argv"])
    at = argv.index("--device") + 1
    device = init_distributed(torch.device(argv[at]).type)
    argv[at] = str(device)
    rank, start = dist.get_rank(), spec["start"]
    cfg = load_config(argv[argv.index("--config") + 1])
    every, phase = cfg.snapshot_save_iter, cfg.log_iter % cfg.snapshot_save_iter
    state = {"done": start, "dg": 0, "d_only": 0, "samples": 0, "model": None}
    waited, feed = [0.0], []
    cpu = [(start, round(process_cpu_seconds(), 3))]
    distance: Dict[str, Dict[str, float]] = {}
    step, sample, save = ACLGAN.train_step, ACLGAN.sample, cli_train.save_checkpoint
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec = _Recorder(start, stop_by=spec["stop_by"] if rank == 0 else None,
                    snapshot_every=every, log_iter=cfg.log_iter, raise_on_stop=False)

    def train_step(self, x_a, x_b, do_dis, do_gen, step_increment=1, *a, **kw):
        state["model"] = self
        done = state["done"] + step_increment - 1  # iterations ended before this one
        if spec["stop_by"] is not None and done > start and done % every == phase:
            flag = torch.tensor([int(rec.stop_at == done)], device=device)
            dist.broadcast(flag, 0)
            if flag.item():
                raise Stopped(done)
        out = step(self, x_a, x_b, do_dis, do_gen, step_increment, *a, **kw)
        state["done"] = done + 1
        state["dg" if do_dis and do_gen else "d_only"] += 1
        if state["done"] % cfg.log_iter == 0:
            feed.append((state["done"], round(waited[0], 4)))
            cpu.append((state["done"], round(process_cpu_seconds(), 3)))
            if rank:
                rec.iteration = state["done"]
                rec.sample()
        return out

    def counted_sample(self, *args):
        state["samples"] += 1
        return sample(self, *args)

    def save_and_measure(directory, model, iterations, **kw):
        save(directory, model, iterations, **kw)
        if model.ema is not None:
            distance[str(iterations + 1)] = ema_distance(model)

    k0, t0, stopped = _launches(), time.time(), None
    try:
        with rec, open(f"{spec['out']}.{rank}.log", "w") as log:
            def on_line(line):
                log.write(line + "\n")
                log.flush()
                rec.on_line(line)

            with contextlib.redirect_stdout(_Tee(sys.stdout, on_line)), \
                    mock.patch.object(ACLGAN, "train_step", train_step), \
                    mock.patch.object(ACLGAN, "sample", counted_sample), \
                    mock.patch.object(cli_train, "save_checkpoint", save_and_measure), \
                    mock.patch.object(cli_train, "device_prefetch",
                                      _timed_feed(cli_train.device_prefetch, waited)):
                try:
                    cli_train.main(argv)
                except Stopped as e:
                    stopped = e.iteration
            _sync(device)
    finally:
        torch_ranks.teardown([state["model"]] if state["model"] is not None else [])
    k1, k2 = (b - a for a, b in zip(k0, _launches()))
    _write(Path(f"{spec['out']}.{rank}.json"), {
        "rank": rank, "end": state["done"] if stopped is None else stopped,
        "stopped_at": stopped, "seconds": time.time() - t0,
        "steps": {"dg": state["dg"], "d_only": state["d_only"], "samples": state["samples"]},
        "launches": {"k1": k1, "k2": k2}, "lines": rec.lines, "rss": rec.rss,
        "feed_wait_seconds": feed, "cpu_seconds": cpu,
        "peak_memory": (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                        else None),
        "ema_from_live_rel_l2": distance})


def stage_inception(work: Work, sizes: Sizes, args) -> Dict[str, Any]:
    from aclgan_tpu_torch.cli import train_inception

    if args.inception_weights:
        if not work.inception.is_file():
            raise RuntimeError(f"--inception_weights {work.inception} does not exist")
        return {"skipped": True, "given": str(work.inception)}
    if work.inception.is_file() and work.log("inception").exists():
        return {"skipped": True, **_read(work.log("inception"))}
    argv = ["--data_root", str(work.data_root), "--out", str(work.inception),
            "--steps", str(sizes.inception_steps), "--batch", str(sizes.inception_batch),
            "--size", str(sizes.inception_size), "--seed", str(sizes.inception_seed),
            "--device", args.device]
    r = train_inception.main(argv)
    doc = {"argv": argv, **{k: v if isinstance(v, str) else float(v) for k, v in r.items()}}
    _write(work.log("inception"), doc)
    return doc


def _sweep(work: Work, sizes: Sizes, args, prefix: str, run_dir: Path,
           start_after: int = 0) -> Dict[str, Any]:
    """`cli.fid_curve.main` over the `prefix` snapshots of `run_dir` after
    `start_after`: its argv and seconds, the snapshots it scored, each one's
    seconds and its host sqrtm's, and the (K1, K2) launches beside the count
    its batches give."""
    from aclgan_tpu_torch.cli import fid_curve

    argv = ["--config", str(work.config), "--run_dir", str(run_dir),
            "--inception_weights", str(work.inception), "--n", str(sizes.curve_n),
            "--styles", str(sizes.styles), "--bootstrap", str(sizes.bootstrap),
            "--prefix", prefix, "--device", args.device]
    if start_after:
        argv += ["--start_after", str(start_after)]
    k0 = _launches()
    t0 = time.time()
    r = fid_curve.main(argv)
    _sync(torch.device(args.device))
    scored = [s for s in snapshot_stamps(Path(run_dir) / "checkpoints", prefix)
              if s > start_after]
    batches = math.ceil(sizes.curve_n / min(fid_curve.BATCH, sizes.curve_n))
    return {"argv": argv, "seconds": time.time() - t0, "scored": scored,
            "seconds_a_snapshot": r["seconds"], "fid_seconds": r["fid_seconds"],
            "launches": {"k1": _launches()[0] - k0[0], "k2": _launches()[1] - k0[1]},
            "derived": {"k1": (chip_smoke.LAUNCHES_PER_BATCH * batches * sizes.styles
                               * len(scored)),
                        "k2": 0}}


def _log_sweeps(work: Work, sweeps: Dict[str, Dict[str, Any]], **keys) -> None:
    with _locked(work.log("curves_log")):  # scorers in other processes write it too
        log = _read(work.log("curves_log"), {"sweeps": []})
        log["sweeps"] += [dict(v, prefix=p, **keys) for p, v in sweeps.items()
                          if not v.get("skipped")]
        _write(work.log("curves_log"), log)


def stage_curves(work: Work, sizes: Sizes, args, families=PREFIXES) -> Dict[str, Any]:
    ensure_config(work, sizes)
    out = {}
    for prefix in families:
        start_after = curve_plan(_read(work.curve(prefix)),
                                 snapshot_stamps(work.checkpoints, prefix),
                                 curve_meta(sizes, prefix))
        out[prefix] = ({"skipped": True} if start_after is None else
                       _sweep(work, sizes, args, prefix, work.run_dir, start_after))
    _log_sweeps(work, out)
    return out


def stage_score(work: Work, sizes: Sizes, args) -> Dict[str, Any]:
    """Scorer `--worker K` of `all --score_after`: one `cli.fid_curve` sweep
    a family of its share in DIR/score_plan.json, over its run directory
    (`Work.scorer_dir`), whose checkpoints/ hard-links the share's snapshot
    files; the sweeps' curve files there are its part files. Writes
    DIR/score.<K>.json after each sweep."""
    share = [tuple(x) for x in _read(work.log("score_plan"))["workers"][args.worker]["share"]]
    run_dir = work.scorer_dir(args.worker)
    (run_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
    for p, it in share:  # hard links: the CLI leaves symlinks (aliases) out
        link = run_dir / "checkpoints" / f"{p}_{it:08d}.pt"
        if not link.exists():
            os.link(work.checkpoints / link.name, link)
    t0 = time.time()
    out: Dict[str, Any] = {"worker": args.worker, "share": share, "sweeps": {}}
    for p in PREFIXES:
        if any(q == p for q, _ in share):
            out["sweeps"][p] = _sweep(work, sizes, args, p, run_dir)
            _log_sweeps(work, {p: out["sweeps"][p]}, worker=args.worker)
            out["seconds"] = time.time() - t0
            _write(work.log(f"score.{args.worker}"), out)
    return out


def merge_parts(work: Work, sizes: Sizes) -> Dict[str, int]:
    """Adds the rows of every part file under DIR/score to DIR's curve file
    of its family (a part's row wins over the curve's at one iteration),
    sorted by iteration, `best` and `complete` (every snapshot on disk has a
    row) recomputed, as one sweep writes them; a family no part adds to is
    left as it is. Refuses a part or a curve file of another protocol.
    Returns the rows each family gained."""
    out = {}
    for p in PREFIXES:
        meta, doc = curve_meta(sizes, p), _read(work.curve(p))
        parts = [(path, _read(path)) for path in work.parts(p)]
        for path, d in ([(work.curve(p), doc)] if doc is not None else []) + parts:
            got = {k: d.get(k) for k in meta}
            if got != meta:
                raise ValueError(f"{path} was taken under another protocol: {got} against {meta}")
        before = {r["iteration"]: r for r in (doc or {}).get("rows", [])}
        rows = dict(before)
        for _, d in parts:
            rows.update((r["iteration"], r) for r in d["rows"])
        out[p] = len(rows) - len(before)
        if rows == before:
            continue
        stamps = snapshot_stamps(work.checkpoints, p)
        merged = {"rows": [rows[i] for i in sorted(rows)], **meta,
                  "complete": bool(stamps) and set(stamps) <= set(rows)}
        merged["best"] = min(merged["rows"], key=lambda r: r["fid"])
        work.curve(p).parent.mkdir(parents=True, exist_ok=True)
        _write(work.curve(p), merged)
    return out


@contextlib.contextmanager
def _locked(path: Path):
    """An exclusive lock on `path`.lock for the block (between processes)."""
    import fcntl

    with open(f"{path}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def unscored(work: Work, sizes: Sizes, families=PREFIXES) -> Dict[str, int]:
    """The snapshots on disk with no row in their family's curve yet, by family."""
    out = {}
    for prefix in families:
        stamps = snapshot_stamps(work.checkpoints, prefix)
        doc = _read(work.curve(prefix))
        done = {r["iteration"] for r in doc.get("rows", [])} if doc else set()
        if stamps:
            curve_plan(doc, stamps, curve_meta(sizes, prefix))  # refuses another protocol
        out[prefix] = len(set(stamps) - done)
    return out


FOLLOW_POLL = 10.0  # seconds between looks for new snapshots


def stage_follow(work: Work, sizes: Sizes, args) -> Dict[str, Any]:
    """The classifier and the calibration, then the curves of `--families`
    (both by default) over each snapshot as a train stage running beside
    this one writes it, until that stage has ended (`Work.train_done`, or
    this process's parent is gone); then the last snapshots. A `follow`
    whose families leave out the first waits for the classifier that the
    first's `follow` trains and calibrates."""
    parent = os.getppid()
    families = tuple(args.families.split(",")) if args.families else PREFIXES
    out: Dict[str, Any] = {"sweeps": []}
    if PREFIXES[0] in families:
        out["inception"] = stage_inception(work, sizes, args)
        out["calibrate"] = stage_calibrate(work, sizes, args)
    else:
        while not work.log("inception").exists() and os.getppid() == parent:
            time.sleep(FOLLOW_POLL / 10)
    while True:
        ended = work.train_done.exists() or os.getppid() != parent
        if any(unscored(work, sizes, families).values()):
            out["sweeps"].append(stage_curves(work, sizes, args, families))
        elif ended:
            return out
        else:
            time.sleep(FOLLOW_POLL)


def calibration_fids(cfg: Config, inception: Path, data_root: Path, n: int,
                     device: str) -> Dict[str, Any]:
    """FID(testA, testB) and FID(trainB[:n], testB) under one classifier,
    and the share of real testB and of real testA it rates as B (the A->B
    curves' target-domain rate, on real images), each side loaded as the
    A->B curve loads its real side."""
    from aclgan_tpu_torch.cli.fid_curve import image_batches
    from aclgan_tpu_torch.data.dataset import list_images_folder
    from aclgan_tpu_torch.eval.fid import feature_stats, frechet_distance
    from aclgan_tpu_torch.eval.inception import InceptionScorer

    scorer = InceptionScorer(str(inception), device=device)
    feats, as_b = {}, {}
    for d in ("testB", "testA", "trainB"):
        parts, hits = [], []
        for b, valid in image_batches(cfg, list_images_folder(str(data_root / d))[:n]):
            img01 = (b + 1.0) / 2.0
            parts.append(scorer.features(img01)[:valid])
            if d != "trainB":
                hits.append(np.argmax(scorer.predict(img01)[:valid], -1) == 1)
        feats[d] = np.concatenate(parts, 0)
        if hits:
            as_b[d] = round(float(np.mean(np.concatenate(hits))), 4)
    real = feature_stats(feats["testB"])
    out = {"n": n, "real_as_b": as_b}

    def timed(side):
        t0 = time.time()
        return round(float(frechet_distance(*real, *feature_stats(feats[side]))), 3), \
            time.time() - t0

    sides = {"domain_gap": "testA", "floor": "trainB"}
    with ThreadPoolExecutor(len(sides)) as pool:  # the two host sqrtm at once
        for key, (fid, secs) in zip(sides, pool.map(timed, sides.values())):
            out[key], out[f"{key}_sqrtm_seconds"] = fid, secs
    return out


def stage_calibrate(work: Work, sizes: Sizes, args) -> Dict[str, Any]:
    doc = _read(work.log("calibrate"))
    if doc is not None and doc.get("n") == sizes.curve_n:
        return {"skipped": True, **doc}
    cfg = ensure_config(work, sizes)
    doc = calibration_fids(cfg, work.inception, work.data_root, sizes.curve_n, args.device)
    _write(work.log("calibrate"), doc)
    return doc


def stage_classifier(work: Work, sizes: Sizes, args) -> Dict[str, Any]:
    """The classifier and the calibration, what `all --score_after` runs
    beside training; its seconds and the time it ended to
    DIR/classifier.json."""
    t0 = time.time()
    out = {"inception": stage_inception(work, sizes, args),
           "calibrate": stage_calibrate(work, sizes, args)}
    _write(work.log("classifier"), {"seconds": round(time.time() - t0, 1), "ended": time.time()})
    return out


# printed by `cli.fid_curve` for each row, and after each sweep
_ROW = re.compile(r"^iter +(\d+): FID ([0-9.]+)  target-domain rate ([0-9.]+|nan)"
                  r"(?:  styles (\[[^\]]*\]) spread ([0-9.]+))?(?:  ci95 (\[[^\]]*\]))? \(")
_WROTE = re.compile(r"^wrote .*fid_curve_(gen|ema)\.json$")


def curve_rows_from_log(text: str, family: Optional[str] = None) -> Dict[str, Dict[int, Any]]:
    """The rows `cli.fid_curve` printed into a `follow` log, by family: a
    row belongs to the family of the next `wrote .../fid_curve_<family>.json`
    line (the end of its sweep), or to `family` (a one-family log) when its
    sweep was cut before that line; the last print of an iteration wins.
    `n_fake`, `n_real` and `fid_f32_minus_f64` are not printed."""
    out: Dict[str, Dict[int, Any]] = {p: {} for p in PREFIXES}
    pending: Dict[int, Any] = {}
    for line in text.splitlines():
        m = _ROW.match(line)
        if m:
            row = {"iteration": int(m[1]), "fid": float(m[2]),
                   "target_domain_rate": float(m[3])}
            if m[4]:
                row.update(fid_styles=json.loads(m[4]), fid_spread=float(m[5]))
            if m[6]:
                row["fid_ci95"] = json.loads(m[6])
            pending[row["iteration"]] = row
        elif _WROTE.match(line):
            out[_WROTE.match(line)[1]].update(pending)
            pending = {}
    if family is not None:
        out[family].update(pending)
    return out


def stage_recover(work: Work, sizes: Sizes, args) -> Dict[str, Any]:
    """The curve files of a call that was cut before it copied them out,
    rebuilt from the `follow` logs it did copy (`curve_rows_from_log`;
    `follow_<family>.log` holds that family alone), under this run's
    protocol and `complete` False; a curve file already there is kept.
    Then the rows of the part files a cut `all --score_after` left under
    DIR/score are merged in (`merge_parts`)."""
    rows: Dict[str, Dict[int, Any]] = {p: {} for p in PREFIXES}
    for log in sorted(work.root.glob("follow*.log")):
        family = log.stem.split("_", 1)[1] if "_" in log.stem else None
        for p, got in curve_rows_from_log(log.read_text(), family).items():
            rows[p].update(got)
    out = {}
    for p in PREFIXES:
        if work.curve(p).exists() or not rows[p]:
            out[p] = {"skipped": True}
            continue
        doc = {"rows": [rows[p][i] for i in sorted(rows[p])], **curve_meta(sizes, p),
               "complete": False}
        doc["best"] = min(doc["rows"], key=lambda r: r["fid"])
        work.curve(p).parent.mkdir(parents=True, exist_ok=True)
        _write(work.curve(p), doc)
        out[p] = {"rows": len(doc["rows"]), "last": doc["rows"][-1]["iteration"]}
    for p, added in merge_parts(work, sizes).items():
        if added:
            rows = _read(work.curve(p))["rows"]
            out[p] = {"rows": len(rows), "last": rows[-1]["iteration"], "from_parts": added}
    return out


# ------------------------------------------------------------------ report
class Refused(ValueError):
    """`tools/fid_compare.compare` refused two curves (another protocol)."""


def curve_summary(doc: Dict[str, Any], after: int = 3000) -> Dict[str, Any]:
    """A curve's mean FID, best row, worst FID after `after` and lowest rate."""
    rows = doc["rows"]
    best = min(rows, key=lambda r: r["fid"])
    late = [r["fid"] for r in rows if r["iteration"] > after]
    return {"iterations": [r["iteration"] for r in rows],
            "mean_fid": round(sum(r["fid"] for r in rows) / len(rows), 3),
            "best": {"iteration": best["iteration"], "fid": best["fid"],
                     "fid_ci95": best.get("fid_ci95")},
            f"worst_after_{after}": max(late) if late else None,
            "min_rate": min(r["target_domain_rate"] for r in rows),
            "complete": doc.get("complete")}


def check_bars(curves: Dict[str, Dict[str, Any]], accuracy: Optional[float],
               calib: Optional[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Each bar of `BARS` as {value, limit, pass}; `pass` is None where the
    run holds nothing to judge it by."""
    def bar(value, limit, ok):
        return {"value": value, "limit": limit, "pass": None if value is None else bool(ok)}

    rows = {p: {r["iteration"]: r for r in doc["rows"]} for p, doc in curves.items()}
    out = {"classifier_accuracy": bar(accuracy, f">= {BARS['accuracy_min']}",
                                      accuracy is not None
                                      and accuracy >= BARS["accuracy_min"])}
    late = [r["target_domain_rate"] for p in rows for it, r in rows[p].items()
            if it >= BARS["rate_from"]]
    out["target_domain_rate"] = bar(min(late) if late else None,
                                    f">= {BARS['rate_min']} from {BARS['rate_from']} on",
                                    late and min(late) >= BARS["rate_min"])
    w = BARS["warmup_iteration"]
    if all(w in rows.get(p, {}) for p in PREFIXES):
        e, g = rows["ema"][w]["fid"], rows["gen"][w]["fid"]
        out["ema_warmup"] = bar({"ema": e, "gen": g}, f"FID(ema@{w}) > FID(gen@{w})", e > g)
    else:
        out["ema_warmup"] = bar(None, f"FID(ema@{w}) > FID(gen@{w})", False)
    best = min((r["fid"] for p in rows for r in rows[p].values()), default=None)
    gap = calib.get("domain_gap") if calib else None
    ratio = None if best is None or not gap else round(best / gap, 4)
    out["best_over_domain_gap"] = bar(
        ratio, f"<= {BARS['best_over_gap_max']}",
        ratio is not None and ratio <= BARS["best_over_gap_max"])
    out["best_over_domain_gap"].update(best_fid=best, domain_gap=gap,
                                       floor=calib.get("floor") if calib else None)
    return out


def classifier_gate(calib: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The gate of `BARS` on calibration's real-test rates: {value, limit,
    pass}, `pass` None without those rates."""
    rates = (calib or {}).get("real_as_b")
    limit = (f"real testB as B >= {BARS['real_b_as_b_min']}, real testA as B <= "
             f"{BARS['real_a_as_b_max']}")
    if not rates:
        return {"value": None, "limit": limit, "pass": None}
    return {"value": rates, "limit": limit,
            "pass": bool(rates["testB"] >= BARS["real_b_as_b_min"]
                         and rates["testA"] <= BARS["real_a_as_b_max"])}


def read_bars(bars: Dict[str, Dict[str, Any]], gate: Dict[str, Any]
              ) -> Tuple[Dict[str, Dict[str, Any]], str]:
    """The bars behind the gate, and the run's verdict. A failed gate voids
    every bar: its `pass` (and `pass_on_present`) become None and it says
    why. Otherwise the verdict names the bars that failed or could not be
    judged."""
    if gate["pass"] is False:
        voided = {k: dict(b, **{f: None for f in ("pass", "pass_on_present") if f in b},
                          not_read=GATE_FAILED) for k, b in bars.items()}
        return {"classifier_gate": gate, **voided}, GATE_FAILED
    failed = [k for k, b in bars.items() if b["pass"] is False]
    open_ = [k for k, b in bars.items() if b["pass"] is None]
    if gate["pass"] is None:
        open_.insert(0, "classifier_gate")
    verdict = ("every bar held" if not failed and not open_ else
               "; ".join(x for x in (f"failed: {', '.join(failed)}" if failed else "",
                                     f"not judged: {', '.join(open_)}" if open_ else "") if x))
    return {"classifier_gate": gate, **bars}, verdict


def ema_rules(curves: Dict[str, Dict[str, Any]], every: int = 1000) -> Dict[str, Dict[str, Any]]:
    """The EMA's two rules of `BARS` over the snapshots of both families in
    its window, each as {value, limit, snapshots, of, pass}: `pass` is None
    unless every snapshot of the window (one each `every`) is there, and
    `pass_on_present` judges the ones that are. The EMA's win count there
    comes beside them, held to nothing."""
    lo, hi = BARS["ema_window"]
    fid = {p: {r["iteration"]: r["fid"] for r in curves[p]["rows"] if lo <= r["iteration"] <= hi}
           for p in PREFIXES}
    its = sorted(set(fid["gen"]) & set(fid["ema"]))
    want = len(range(lo, hi + 1, every))

    def rule(value, limit, ok):
        judged = bool(ok) if its else None
        return {"value": value, "limit": limit, "snapshots": len(its), "of": want,
                "pass": judged if len(its) == want else None, "pass_on_present": judged}

    if not its:
        return {"ema_steadiness": rule(None, f"EMA range < live range over {lo}-{hi}", False),
                "ema_level": rule(None, f"<= {BARS['ema_median_over_live_max']}", False),
                "ema_wins": {"ema": None, "gen": None, "snapshots": 0}}
    ema, live = [fid["ema"][i] for i in its], [fid["gen"][i] for i in its]
    spans = {"ema_range": round(max(ema) - min(ema), 3),
             "live_range": round(max(live) - min(live), 3)}
    medians = {"ema_median": float(np.median(ema)), "live_median": float(np.median(live))}
    ratio = round(medians["ema_median"] / medians["live_median"], 4)
    wins = sum(e < g for e, g in zip(ema, live))
    return {"ema_steadiness": rule(spans, f"EMA range < live range over {lo}-{hi}",
                                   spans["ema_range"] < spans["live_range"]),
            "ema_level": rule(dict(medians, ratio=ratio),
                              f"<= {BARS['ema_median_over_live_max']}",
                              ratio <= BARS["ema_median_over_live_max"]),
            "ema_wins": {"ema": wins, "gen": len(its) - wins, "snapshots": len(its)}}


@torch.no_grad()
def ema_distance(model) -> Dict[str, float]:
    """The EMA generators' rel-L2 from the live ones, per generator:
    sqrt(sum |ema - live|^2 / sum |live|^2) over every weight, in float64."""
    out = {}
    for n, ema in model.ema.items():
        live = dict(model.gen(n).named_parameters())
        diff = sum((t.double() - live[k].double()).square().sum() for k, t in ema.items())
        norm = sum(live[k].double().square().sum() for k in ema)
        out[n] = round(float((diff / norm).sqrt()), 6)
    return out


def rss_profile(rss: List[Tuple[float, int, int]], start: int, end: int,
                every: int = 1000) -> Dict[str, Any]:
    """VmRSS (GiB) at the first sample at or past each multiple of `every` in
    (start, end], and the least-squares slope from iteration start + 500 on
    (GiB per 1,000 iterations)."""
    at = {}
    for k in range(start - start % every + every, end + 1, every):
        r = next((r for _, it, r in rss if it >= k), None)
        if r is not None:
            at[str(k)] = round(r / 2**30, 4)
    slope = rss_slope([(it, r) for _, it, r in rss], start + 500)
    return {"rss_gib_per_1000": at,
            "rss_slope_gib_per_1000_after_500": None if slope is None else round(slope, 5)}


def _window_p50(lines, log_iter: int, window: int = 1000) -> Dict[str, float]:
    """p50 seconds an iteration of each `window` of iterations, from the CLI's
    `Iteration:` lines (seconds per log_iter iterations)."""
    by: Dict[int, List[float]] = {}
    for it, secs in lines:
        by.setdefault((it - 1) // window, []).append(secs / log_iter)
    return {f"{k * window + 1}-{(k + 1) * window}": round(float(np.median(v)), 5)
            for k, v in sorted(by.items())}


def train_summary(log: Dict[str, Any], scalars: Path, stamps: Dict[str, List[int]],
                  snapshot_every: int) -> Dict[str, Any]:
    segs = log["segments"]
    end = max(s["end"] for s in segs)
    nonfinite = 0
    if scalars.exists():
        for line in scalars.read_text().splitlines():
            rec = json.loads(line)
            nonfinite += sum(1 for v in rec.values()
                             if isinstance(v, float) and not math.isfinite(v))
    want = list(range(snapshot_every, end + 1, snapshot_every))
    out = {"iterations": end, "nonfinite_logged": nonfinite,
           "snapshots": {p: stamps[p] for p in PREFIXES},
           "snapshots_missing": {p: [s for s in want if s not in stamps[p]]
                                 for p in PREFIXES},
           "segments": []}
    for s in segs:
        seg = {"iterations": [s["start"], s["end"]], "seconds": round(s["seconds"], 1),
               "s_per_iteration_p50": _window_p50(s["iteration_lines"], s["log_iter"]),
               **_memory_summary(s, s["start"], s["end"]),
               "stopped_at": s.get("stopped_at"),
               "launches": s["launches"], "derived": s["derived"],
               "launches_ok": _launches_ok(s, s["device"])}
        if "ranks" in s:
            seg["world"] = s["world"]
            seg["ranks"] = [_rank_summary(r, s) for r in s["ranks"]]
        out["segments"].append(seg)
    return out


def _memory_summary(rec: Dict[str, Any], start: int, end: int) -> Dict[str, Any]:
    """Peak device memory and VmRSS (start, at iteration start + 500, end,
    max; growth from 500 against `RSS_GROWTH_MAX`; each 1,000 and the slope)
    of one process's record."""
    rss = rec["rss"]
    at500 = next((r for _, it, r in rss if it >= start + 500), None)
    return {"peak_memory_gib": (None if rec["peak_memory"] is None
                                else round(rec["peak_memory"] / 2**30, 3)),
            "rss_gib": {"start": round(rss[0][2] / 2**30, 3) if rss else None,
                        "iteration_500": None if at500 is None else round(at500 / 2**30, 3),
                        "end": round(rss[-1][2] / 2**30, 3) if rss else None,
                        "max": round(max(r for *_, r in rss) / 2**30, 3) if rss else None},
            "rss_growth_after_500_ok": (None if at500 is None or not rss else
                                        rss[-1][2] - at500 < RSS_GROWTH_MAX),
            **rss_profile(rss, start, end)}


def _launches_ok(rec: Dict[str, Any], device: str) -> Optional[bool]:
    """(K1, K2) against the cadence's count (None off a card: the plain
    versions count nothing)."""
    if not device.startswith("cuda"):
        return None
    return ((rec["launches"]["k1"], rec["launches"]["k2"])
            == (rec["derived"]["k1"], rec["derived"]["k2"]))


def _rank_summary(r: Dict[str, Any], seg: Dict[str, Any], every: int = 1000) -> Dict[str, Any]:
    """One rank of a `--world N` segment: its steps and samples and its
    (K1, K2) against the cadence's, its memory, the share of each `every`
    iterations' seconds (rank 0's lines) it spent waiting on its feed, and
    beside it its process's CPU seconds a second over the same iterations."""
    d = r["derived"]
    waits = {seg["start"]: 0.0, **dict(r["feed_wait_seconds"])}  # cumulative, at lines
    cpu = dict(r.get("cpu_seconds", []))  # cumulative, at lines
    wall: Dict[int, List[float]] = {}  # window -> [seconds, its last line's iteration]
    for it, secs in seg["iteration_lines"]:
        w = wall.setdefault((it - 1) // every, [0.0, it])
        w[0], w[1] = w[0] + secs, it
    share, cores = {}, {}
    for k, (secs, hi) in sorted(wall.items()):
        lo = max(k * every, seg["start"])
        if lo in waits and hi in waits and secs > 0:
            share[f"{lo + 1}-{hi}"] = round((waits[hi] - waits[lo]) / secs, 4)
        if lo in cpu and hi in cpu and secs > 0:
            cores[f"{lo + 1}-{hi}"] = round((cpu[hi] - cpu[lo]) / secs, 4)
    return {"rank": r["rank"], "end": r["end"], "stopped_at": r["stopped_at"],
            "steps": r["steps"], "launches": r["launches"],
            "steps_ok": (r["steps"]["dg"], r["steps"]["d_only"], r["steps"]["samples"])
            == (d["dg"], d["d_only"], d["samples"]),
            "launches_ok": _launches_ok(r, seg["device"]),
            "feed_wait_share": share, "cpu_seconds_a_second": cores,
            **_memory_summary(r, seg["start"], seg["end"])}


def _device_line() -> Optional[str]:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None


def snapshot_grid(cfg: Config, snap: Path, out: Path, device: str) -> Path:
    """The test grid of the train CLI (its display batches and noise) drawn
    with the generators of `snap`, shrunk by 3 in each side (a JPEG)."""
    from PIL import Image

    from aclgan_tpu_torch.cli.train import display_batches, display_noise
    from aclgan_tpu_torch.data.loader import get_all_data_loaders
    from aclgan_tpu_torch.trainer import ACLGAN
    from aclgan_tpu_torch.utils.checkpoint import load_generators
    from aclgan_tpu_torch.utils.image import write_2images

    model = ACLGAN(cfg, device=device)
    load_generators(str(snap), model)
    displays = display_batches(get_all_data_loaders(cfg, seed=cfg.seed), cfg.display_size, None)
    n = len(displays[0])
    xa, xb = (torch.from_numpy(d).to(model.device) for d in displays[2:])
    outs = [o.cpu().numpy() for o in model.sample(xa, xb, *display_noise(cfg, n, model.device))]
    full = Path(write_2images(outs, n, str(out.parent), "full_" + out.stem))
    with Image.open(full) as im:
        im.convert("RGB").resize((im.width // 3, im.height // 3), Image.BILINEAR).save(
            out, quality=85)
    full.unlink()
    return out


def report(work: Work, sizes: Sizes, recorded: Optional[Path], docs: Optional[Path],
           device: str = "cpu") -> Dict[str, Any]:
    """The summary of the run (see the module docstring). Raises `Refused`
    when `fid_compare.compare` refuses a pair of curves."""
    fc = _fid_compare()
    curves = {p: _read(work.curve(p)) for p in PREFIXES}
    missing = [p for p, d in curves.items() if d is None]
    if missing:
        raise RuntimeError(f"no {missing} curve under {work.run_dir}")

    def compare(a, b, name_a, name_b):
        try:
            return fc.compare(a, b, name_a, name_b)
        except ValueError as e:
            raise Refused(f"{name_a} against {name_b}: {e}") from e

    families = compare(curves["gen"], curves["ema"], "gen", "ema")
    against = {}
    if recorded is not None:
        for p in PREFIXES:
            against[p] = compare(json.loads((recorded / f"fid_curve_{p}.json").read_text()),
                                 curves[p], "jax", "torch")
    inc = _read(work.log("inception"))
    calib = _read(work.log("calibrate"))
    cfg = load_config(work.config)
    stamps = {p: snapshot_stamps(work.checkpoints, p) for p in PREFIXES}
    log = _read(work.log("train_log"))
    rules = ema_rules(curves, cfg.snapshot_save_iter)
    wins = rules.pop("ema_wins")
    bars, verdict = read_bars({**check_bars(curves, inc.get("accuracy") if inc else None,
                                            calib), **rules}, classifier_gate(calib))
    summary = {
        "config": f"configs/{STEM}.yaml", "sizes": dataclasses.asdict(sizes),
        "device": _device_line() if device == "cuda" else "cpu",
        "curves": {p: curve_summary(d) for p, d in curves.items()},
        "gen_against_ema": {"wins": families["wins"], "mean_fid": families["mean_fid"]},
        "against_recorded": {p: {"mean_fid": c["mean_fid"], "wins": c["wins"],
                                 "rows": c["rows"]} for p, c in against.items()},
        "classifier": inc, "calibrate": calib, "verdict": verdict, "bars": bars,
        "ema_wins_in_window": wins,
        "ema_from_live_rel_l2": {k: v for seg in (log or {}).get("segments", [])
                                 for k, v in seg.get("ema_from_live_rel_l2", {}).items()},
        "train": (train_summary(log, work.scalars, stamps, cfg.snapshot_save_iter)
                  if log else None),
        "curve_sweeps": _read(work.log("curves_log")),
        "alongside": _read(work.log("alongside")),
    }
    best = min(((p, r) for p, d in curves.items() for r in d["rows"]),
               key=lambda pr: pr[1]["fid"])
    summary["selected"] = {"prefix": best[0], "iteration": best[1]["iteration"],
                           "fid": best[1]["fid"]}
    if docs is not None:
        docs.mkdir(parents=True, exist_ok=True)
        for p in PREFIXES:
            shutil.copy(work.curve(p), docs / f"fid_curve_{p}.json")
        snap = work.checkpoints / f"{best[0]}_{best[1]['iteration']:08d}.pt"
        if snap.exists() and snap.stat().st_size:  # a recovered record lists snapshots only
            path = docs / f"{best[0]}_a2b_test_hard_{best[1]['iteration']:08d}_small.jpg"
            summary["selected"]["grid"] = snapshot_grid(cfg, snap, path, device).name
        _write(docs / "summary.json", _relative(summary))
    _write(work.log("summary"), summary)
    _print_report(summary, curves, against)
    return summary


def _print_report(summary, curves, against) -> None:
    real = (summary["calibrate"] or {}).get("real_as_b", {})
    for p in PREFIXES:
        print(f"\n{p} family: the port's rows beside the recorded JAX run's")
        print("| iteration | torch FID (spread) | jax FID (spread) | torch - jax | rate |")
        print("|---|---|---|---|---|")
        rec = {r["iteration"]: r for r in against[p]["rows"]} if p in against else {}
        for r in curves[p]["rows"]:
            j = rec.get(r["iteration"])
            jtxt = f"{j['jax']} ({j['jax_spread']})" if j else "-"
            delta = f"{j['delta']:+}" if j else "-"
            print(f"| {r['iteration']} | {r['fid']} ({r.get('fid_spread')}) | {jtxt} | "
                  f"{delta} | {r['target_domain_rate']} |")
        s = summary["curves"][p]
        print(f"mean {s['mean_fid']}, best {s['best']}, lowest rate {s['min_rate']}; "
              f"the classifier rates real testB as B at {real.get('testB')}, real testA "
              f"at {real.get('testA')}")
    for seg in (summary["train"] or {}).get("segments", []):
        for r in seg.get("ranks", []):
            print(f"\nrank {r['rank']}, iterations {seg['iterations']}: feed-wait share / "
                  "CPU seconds a second of each 1,000\n" + ", ".join(
                      f"{w} {s} / {r['cpu_seconds_a_second'].get(w, 'not measured')}"
                      for w, s in r["feed_wait_share"].items()))
    print(f"\nverdict: {summary['verdict']}")
    print("bars: " + json.dumps(summary["bars"]))


# ------------------------------------------------------------------ command line
SCORER_THREADS = 4  # OpenMP / BLAS threads of each child process (its host sqrtm)
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def scorer_plan(score_on: Optional[str]) -> List[Tuple[Optional[str], Tuple[str, ...]]]:
    """(card, families) of each `follow`: one on the run's device for both
    families by default, one on the named card, or one a family on two."""
    cards = _cards(score_on)
    if len(cards) == 1:
        return [(cards[0], PREFIXES)]
    if len(cards) != len(PREFIXES):
        raise ValueError(f"--score_on names one card or {len(PREFIXES)}, not {score_on!r}")
    return [(c, (p,)) for c, p in zip(cards, PREFIXES)]


def _cards(score_on: Optional[str]) -> List[Optional[str]]:
    return [c.strip() for c in score_on.split(",")] if score_on else [None]


def _start_child(work: Work, args, stage: str, card: Optional[str], name: str,
                 extra: Tuple[str, ...] = ()):
    """This tool's `stage` in a child process that sees only `card` (all of
    the run's devices when None), its OpenMP / BLAS threads capped at
    `--scorer_threads`, its output in DIR/<name>.log. Returns (name, log,
    process)."""
    cmd = [sys.executable, str(Path(__file__).resolve()), stage, "--work", str(work.root),
           "--device", args.device, "--data_root", str(work.data_root)]
    if args.smoke:
        cmd.append("--smoke")
    if args.inception_weights:
        cmd += ["--inception_weights", str(work.inception)]
    cmd += list(extra)
    env = dict(os.environ, **{k: str(args.scorer_threads) for k in THREAD_VARS})
    if card is not None:
        env["CUDA_VISIBLE_DEVICES"] = card
    log = open(work.root / f"{name}.log", "a")
    return name, log, subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                       stderr=subprocess.STDOUT)


def _stop(children) -> None:
    """Ends the children still running (a cut call), killing what is left
    after 10 s, and closes their logs."""
    live = [child for _, _, child in children if child.poll() is None]
    for child in live:
        child.terminate()
    until = time.time() + 10
    for child in live:
        try:
            child.wait(timeout=max(0.0, until - time.time()))
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
    for _, log, _ in children:
        log.close()


def _failed(what: str, work: Work, codes: Dict[str, int]) -> RuntimeError:
    return RuntimeError(f"the {what} stage failed {codes}; see "
                        + ", ".join(str(work.root / f"{n}.log") for n in codes))


def run_alongside(work: Work, sizes: Sizes, args, recorded, docs) -> Dict[str, Any]:
    """`all` with the curves scored beside training: the dataset, then each
    `follow` of `scorer_plan` in a child process while `train` runs (in
    this one, or on its ranks), then `report`. What was left to score when
    training ended (written then) and how long scoring ran on (written when
    it ends) go to DIR/alongside.json."""
    out = {"dataset": stage_dataset(work, sizes, args)}
    ensure_config(work, sizes)
    work.train_done.unlink(missing_ok=True)
    plan = scorer_plan(args.score_on)
    children = [_start_child(work, args, "follow", card,
                             "follow" if families == PREFIXES else f"follow_{families[0]}",
                             () if families == PREFIXES else ("--families", ",".join(families)))
                for card, families in plan]
    try:
        out["train"] = stage_train(work, sizes, args)
    finally:
        t_end = time.time()
        # written now too: a call cut while the scorers catch up keeps the backlog
        alongside = {"placement": [[c, list(f)] for c, f in plan],
                     "scorer_threads": args.scorer_threads,
                     "unscored_at_train_end": unscored(work, sizes),
                     "scoring_after_train_seconds": None}
        _write(work.log("alongside"), alongside)
        work.train_done.write_text("")
        codes = {}
        for name, log, child in children:
            codes[name] = child.wait()
            log.close()
    alongside["scoring_after_train_seconds"] = round(time.time() - t_end, 1)
    _write(work.log("alongside"), alongside)
    failed = {n: rc for n, rc in codes.items() if rc}
    if failed:
        raise _failed("follow", work, failed)
    out["report"] = report(work, sizes, recorded, docs, args.device)
    return out


SCORER_POLL = 1.0  # seconds between looks at the running scorers


def run_score_after(work: Work, sizes: Sizes, args, recorded, docs) -> Dict[str, Any]:
    """`all --score_after`: the dataset, then `train` (in this process, or
    on its ranks) while the `classifier` stage runs in a child process on
    the last card of `--score_on`; once both have ended, `score_after`;
    then `report`."""
    out = {"dataset": stage_dataset(work, sizes, args)}
    ensure_config(work, sizes)
    cards = _cards(args.score_on)
    children = [_start_child(work, args, "classifier", cards[-1], "classifier")]
    t0 = time.time()
    try:
        out["train"] = stage_train(work, sizes, args)
        t_end = time.time()
        record = {"mode": "score_after", "scorer_threads": args.scorer_threads,
                  "placement": {"classifier": cards[-1], "scorers": cards},
                  "train_seconds": round(t_end - t0, 1),
                  "snapshots_at_train_end": {p: len(snapshot_stamps(work.checkpoints, p))
                                             for p in PREFIXES},
                  "unscored_at_train_end": unscored(work, sizes),
                  "classifier": None, "scorers": [],
                  "seconds_from_train_end_to_last_row": None}
        _write(work.log("alongside"), record)  # a call cut while scoring keeps the backlog
        name, _, child = children[0]
        if child.wait():
            raise _failed("classifier", work, {name: child.returncode})
        done = _read(work.log("classifier"))
        record["classifier"] = {"seconds": done["seconds"],
                                "ended_after_train_seconds": round(done["ended"] - t_end, 1)}
        _write(work.log("alongside"), record)
        out["score"] = score_after(work, sizes, args, cards, record, t_end, children)
    finally:
        _stop(children)
    out["report"] = report(work, sizes, recorded, docs, args.device)
    return out


def score_after(work: Work, sizes: Sizes, args, cards: List[Optional[str]],
                record: Dict[str, Any], t_end: float, children: list) -> List[Dict[str, Any]]:
    """The curves of every snapshot no curve or part file holds yet, split
    by `score_split` among one `score` child a card of `cards` (DIR/
    score_plan.json), each seeing only its card. As each ends its rows are
    merged into DIR's curve files (`merge_parts`) and its seconds go to
    `record` (DIR/alongside.json), with the seconds from `t_end` (the end
    of training) to the last row. A scorer that fails fails the stage,
    naming its log, after the others have ended and their rows are merged.
    Returns each scorer's DIR/score.<k>.json."""
    merge_parts(work, sizes)  # the rows of a cut call's scorers
    shutil.rmtree(work.root / "score", ignore_errors=True)
    todo = {}
    for p in PREFIXES:
        done = {r["iteration"] for r in (_read(work.curve(p)) or {}).get("rows", [])}
        todo[p] = [s for s in snapshot_stamps(work.checkpoints, p) if s not in done]
    workers = [{"card": c, "share": s} for c, s in zip(cards, score_split(todo, len(cards)))
               if s]
    _write(work.log("score_plan"), {"workers": workers})
    record["placement"]["scorers"] = workers
    for k in range(len(cards)):
        work.log(f"score.{k}").unlink(missing_ok=True)
    started = time.time()
    running = {k: _start_child(work, args, "score", w["card"], f"score_{k}",
                               ("--worker", str(k))) for k, w in enumerate(workers)}
    children += running.values()
    codes = {}
    while running:
        for k, (name, _, child) in list(running.items()):
            if child.poll() is None:
                continue
            del running[k]
            codes[name] = child.returncode
            merge_parts(work, sizes)
            last_row = max((p.stat().st_mtime for f in PREFIXES for p in work.parts(f)),
                           default=None)
            record["scorers"].append({"worker": k, "card": workers[k]["card"],
                                      "snapshots": len(workers[k]["share"]),
                                      "exit": child.returncode,
                                      "seconds": round(time.time() - started, 1),
                                      "log": f"{name}.log"})
            record["seconds_from_train_end_to_last_row"] = (
                None if last_row is None else round(last_row - t_end, 1))
            _write(work.log("alongside"), record)
        if running:
            time.sleep(SCORER_POLL)
    failed = {n: rc for n, rc in codes.items() if rc}
    if failed:
        raise _failed("score", work, failed)
    return [_read(work.log(f"score.{k}")) for k in range(len(workers))]


@contextlib.contextmanager
def _exit_on_sigterm():
    """SIGTERM (a time limit around the tool) raises SystemExit in the main
    thread for the block, so its children are ended on the way out."""
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def stop(signum, frame):
        raise SystemExit(128 + signum)

    old = signal.signal(signal.SIGTERM, stop)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, old)


def main(argv=None) -> Dict[str, Any]:
    t_start = time.time()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", nargs="?", default="all",
                    choices=STAGES + ("all", "follow", "classifier", "score", RECOVER))
    ap.add_argument("--work", required=True, help="the run's directory (resumable)")
    ap.add_argument("--iters", type=int, default=None,
                    help="train to this iteration (default 3000, 40 with --smoke)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--smoke", action="store_true", help="every size shrunk")
    ap.add_argument("--data_root", default=None, help="an existing dataset")
    ap.add_argument("--inception_weights", default=None, help="an existing classifier")
    ap.add_argument("--recorded", default=None,
                    help="the recorded curves to hold the port's against (default "
                         "docs/run_synthfaces_hard; none with --smoke, whose protocol "
                         "differs)")
    ap.add_argument("--alongside", action="store_true",
                    help="with all: score each snapshot as training writes it, in a "
                         "second process")
    ap.add_argument("--score_after", action="store_true",
                    help="with all: score every snapshot after training, split among one "
                         "process a card of --score_on")
    ap.add_argument("--deadline", type=float, default=None,
                    help="stop training after the last snapshot that lands within this "
                         "many seconds of the start")
    ap.add_argument("--world", type=int, default=1,
                    help="train on this many ranks under torchrun, one a card (default 1: "
                         "in this process)")
    ap.add_argument("--score_on", default=None,
                    help="with --alongside: the card of the follow process, or two cards, "
                         "one a family; with --score_after: a card for each scorer, the last "
                         "also training the classifier (default: the run's device)")
    ap.add_argument("--scorer_threads", type=int, default=SCORER_THREADS,
                    help="OpenMP / BLAS threads of each follow, classifier or scorer process")
    ap.add_argument("--docs", default=None,
                    help="where report writes the record (default "
                         "docs/run_synthfaces_hard_torch; DIR/docs with --smoke)")
    ap.add_argument("--families", default=None, help=argparse.SUPPRESS)  # follow's own
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)  # score's own
    args = ap.parse_args(argv)
    args.stop_by = None if args.deadline is None else t_start + args.deadline
    from aclgan_tpu_torch.trainer import resolve_device

    resolve_device(args.device)
    sizes = SMOKE if args.smoke else FULL
    if args.iters is None:
        args.iters = sizes.iters
    work = Work.at(args.work, args.data_root, args.inception_weights)
    docs = Path(args.docs) if args.docs else work.root / "docs" if args.smoke else DOCS
    recorded = Path(args.recorded) if args.recorded else None if args.smoke else RECORDED
    stages = {"dataset": lambda: stage_dataset(work, sizes, args),
              "train": lambda: stage_train(work, sizes, args),
              "inception": lambda: stage_inception(work, sizes, args),
              "curves": lambda: stage_curves(work, sizes, args),
              "calibrate": lambda: stage_calibrate(work, sizes, args),
              "report": lambda: report(work, sizes, recorded, docs, args.device),
              "follow": lambda: stage_follow(work, sizes, args),
              "classifier": lambda: stage_classifier(work, sizes, args),
              "score": lambda: stage_score(work, sizes, args),
              RECOVER: lambda: stage_recover(work, sizes, args)}
    if args.stage == "all" and (args.alongside or args.score_after):
        run = run_score_after if args.score_after else run_alongside
        try:
            with _exit_on_sigterm():
                return run(work, sizes, args, recorded, docs)
        except Refused as e:
            sys.exit(f"refused: {e}")
    out = {}
    for name in STAGES if args.stage == "all" else (args.stage,):
        t0 = time.time()
        print(f"[{STEM}] stage {name}", flush=True)
        try:
            out[name] = stages[name]()
        except Refused as e:
            sys.exit(f"refused: {e}")
        print(f"[{STEM}] stage {name} done in {time.time() - t0:.1f} s", flush=True)
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == [RANK_ENTRY]:
        train_rank(sys.argv[2])
    else:
        main()
