#!/usr/bin/env python3
"""The synthfaces_hard acceptance run of the PyTorch/CUDA port, end to end,
held against the JAX package's recorded run (`docs/run_synthfaces_hard/`).

    python3 tools/torch_synthfaces_hard.py [STAGE] --work DIR [--iters N]
        [--device cuda|cpu] [--smoke] [--data_root DIR] [--inception_weights PT]
        [--recorded DIR] [--alongside] [--deadline S]

STAGE is one of `dataset`, `train`, `inception`, `curves`, `calibrate`,
`report` or `all` (the default: every stage in that order). Each stage runs
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
  S seconds after the command started (the segment's `stopped_at`);
- `inception`: `cli.train_inception.main` at the JAX tool's defaults (300
  steps, batch 32, 149^2, seed 0); its full-set accuracy to DIR/inception.json;
- `curves`: `cli.fid_curve.main` with `--n 500 --styles 3 --bootstrap 100`,
  `--prefix gen` then `--prefix ema`, continued with `--start_after` where
  the curve file already holds rows under the same protocol;
- `calibrate`: under the same classifier and n, FID(testA, testB) (the
  domain gap) and FID(first n of trainB, testB) (the estimator's floor),
  float64 scipy as the curves';
- `report`: both curves beside the recorded ones at the common iterations
  (`tools/fid_compare.compare`, which refuses another protocol), gen
  against ema, the quality bars and the EMA's two rules (`BARS`), the
  EMA's wins in the rules' window, the run's rates and checks (VmRSS at
  each 1,000 iterations and its slope from 500 on, per segment), and a
  test grid of the selected snapshot shrunk by 3, written with both curves
  and `summary.json` to `docs/run_synthfaces_hard_torch` (DIR/docs under
  `--smoke`).

`all --alongside` runs `dataset`, then `train` in this process while a
second process (`follow`, its OpenMP / BLAS threads capped) fine-tunes the
classifier, calibrates and scores each snapshot as it lands; then `report`.

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
PREFIXES = ("gen", "ema")

# The quality bars, set before the run (the JAX run's reading in brackets):
# the classifier's full-set accuracy [1.0]; the target-domain rate at every
# snapshot from 2,000 on, both families [1.0]; FID(ema@1000) above
# FID(gen@1000), the EMA warm-up [32.865 against 5.611]; the best FID of
# both families at most a quarter of the domain gap under the same classifier.
# The EMA's two rules over the snapshots from 10,000 to 20,000: its FID range
# (max - min) narrower than the live weights' [2.889 against 32.838], and its
# median FID at most 1.5x the live weights' [14.804 / 11.689 = 1.266].
BARS = {"accuracy_min": 0.99, "rate_min": 0.99, "rate_from": 2000,
        "warmup_iteration": 1000, "best_over_gap_max": 0.25,
        "ema_window": (10000, 20000), "ema_median_over_live_max": 1.5}
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


def cadence_counts(start: int, end: int, epoch_len: int, cfg: Config) -> Dict[str, int]:
    """What the train CLI runs over global iterations start+1..end of one
    call (the cadence is epoch-local and restarts with the call): D+G and
    D-only iterations, G steps, display samples (two test grids and a train
    grid) and the K1 / K2 launches they make."""
    cadence = chip_smoke._cadence(cfg, epoch_len, start + 1, end)
    samples = sum(2 * (i % cfg.image_save_iter == 0) + (i % cfg.image_display_iter == 0)
                  for i in cadence)
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
    the next snapshot would land later than that at the recent rate."""

    def __init__(self, start: int = 0, every: float = 30.0, stop_by: Optional[float] = None,
                 snapshot_every: int = 1000, log_iter: int = 100):
        super().__init__(every=every, start=start)
        self.lines: List[Tuple[int, float]] = []
        self.stop_by, self.snapshot_every, self.log_iter = stop_by, snapshot_every, log_iter

    def on_line(self, line: str):
        m = chip_smoke._ITERATION.match(line)
        if m:
            self.iteration = int(m[1])
            self.lines.append((self.iteration, float(m[2])))
            self.sample()
            if self.stop_by is not None and self._out_of_time():
                raise Stopped(self.iteration)

    def _out_of_time(self) -> bool:
        if self.iteration % self.snapshot_every != self.log_iter % self.snapshot_every:
            return False  # not the first line after a snapshot
        s_per_it = float(np.median([secs for _, secs in self.lines[-10:]])) / self.log_iter
        left = (self.snapshot_every - self.log_iter) * s_per_it + SNAPSHOT_SECONDS
        return time.time() + left > self.stop_by


def _launches():
    from aclgan_tpu_torch.ops.kernels import instance_norm as K

    return K.launches, K.bwd_launches


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
    log = _read(work.log("train_log"), {"segments": []})
    log["segments"].append(segment)
    _write(work.log("train_log"), log)
    return segment


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
    doc = {"argv": argv, **{k: float(v) for k, v in r.items()}}
    _write(work.log("inception"), doc)
    return doc


def stage_curves(work: Work, sizes: Sizes, args) -> Dict[str, Any]:
    from aclgan_tpu_torch.cli import fid_curve

    ensure_config(work, sizes)
    out = {}
    for prefix in PREFIXES:
        stamps = snapshot_stamps(work.checkpoints, prefix)
        meta = curve_meta(sizes, prefix)
        start_after = curve_plan(_read(work.curve(prefix)), stamps, meta)
        if start_after is None:
            out[prefix] = {"skipped": True}
            continue
        argv = ["--config", str(work.config), "--run_dir", str(work.run_dir),
                "--inception_weights", str(work.inception), "--n", str(sizes.curve_n),
                "--styles", str(sizes.styles), "--bootstrap", str(sizes.bootstrap),
                "--prefix", prefix, "--device", args.device]
        if start_after:
            argv += ["--start_after", str(start_after)]
        k0 = _launches()
        t0 = time.time()
        r = fid_curve.main(argv)
        _sync(torch.device(args.device))
        scored = [s for s in stamps if s > start_after]
        batches = math.ceil(sizes.curve_n / min(fid_curve.BATCH, sizes.curve_n))
        out[prefix] = {
            "argv": argv, "seconds": time.time() - t0, "scored": scored,
            "seconds_a_snapshot": r["seconds"], "fid_seconds": r["fid_seconds"],
            "launches": {"k1": _launches()[0] - k0[0], "k2": _launches()[1] - k0[1]},
            "derived": {"k1": (chip_smoke.LAUNCHES_PER_BATCH * batches * sizes.styles
                               * len(scored)),
                        "k2": 0}}
    log = _read(work.log("curves_log"), {"sweeps": []})
    log["sweeps"] += [dict(v, prefix=p) for p, v in out.items() if not v.get("skipped")]
    _write(work.log("curves_log"), log)
    return out


def _unscored(work: Work, sizes: Sizes) -> bool:
    """Whether a snapshot on disk has no row in its family's curve yet."""
    for prefix in PREFIXES:
        stamps = snapshot_stamps(work.checkpoints, prefix)
        if stamps and curve_plan(_read(work.curve(prefix)), stamps,
                                 curve_meta(sizes, prefix)) is not None:
            return True
    return False


FOLLOW_POLL = 10.0  # seconds between looks for new snapshots


def stage_follow(work: Work, sizes: Sizes, args) -> Dict[str, Any]:
    """The classifier and the calibration, then both curves over each
    snapshot as a train stage running beside this one writes it, until that
    stage has ended (`Work.train_done`, or this process's parent is gone);
    then the last snapshots."""
    parent = os.getppid()
    out = {"inception": stage_inception(work, sizes, args),
           "calibrate": stage_calibrate(work, sizes, args), "sweeps": []}
    while True:
        ended = work.train_done.exists() or os.getppid() != parent
        if _unscored(work, sizes):
            out["sweeps"].append(stage_curves(work, sizes, args))
        elif ended:
            return out
        else:
            time.sleep(FOLLOW_POLL)


def calibration_fids(cfg: Config, inception: Path, data_root: Path, n: int,
                     device: str) -> Dict[str, Any]:
    """FID(testA, testB) and FID(trainB[:n], testB) under one classifier,
    each side loaded as the A->B curve loads its real side."""
    from aclgan_tpu_torch.cli.fid_curve import image_batches, pool3_features
    from aclgan_tpu_torch.data.dataset import list_images_folder
    from aclgan_tpu_torch.eval.fid import feature_stats, frechet_distance
    from aclgan_tpu_torch.eval.inception import InceptionScorer

    scorer = InceptionScorer(str(inception), device=device)
    feats = {d: pool3_features(scorer, image_batches(
        cfg, list_images_folder(str(data_root / d))[:n])) for d in ("testB", "testA", "trainB")}
    real = feature_stats(feats["testB"])
    out = {"n": n}
    for key, side in (("domain_gap", "testA"), ("floor", "trainB")):
        t0 = time.time()
        out[key] = round(float(frechet_distance(*real, *feature_stats(feats[side]))), 3)
        out[f"{key}_sqrtm_seconds"] = time.time() - t0
    return out


def stage_calibrate(work: Work, sizes: Sizes, args) -> Dict[str, Any]:
    doc = _read(work.log("calibrate"))
    if doc is not None and doc.get("n") == sizes.curve_n:
        return {"skipped": True, **doc}
    cfg = ensure_config(work, sizes)
    doc = calibration_fids(cfg, work.inception, work.data_root, sizes.curve_n, args.device)
    _write(work.log("calibrate"), doc)
    return doc


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
        rss = s["rss"]
        at500 = next((r for _, it, r in rss if it >= s["start"] + 500), None)
        seg = {"iterations": [s["start"], s["end"]], "seconds": round(s["seconds"], 1),
               "s_per_iteration_p50": _window_p50(s["iteration_lines"], s["log_iter"]),
               "peak_memory_gib": (None if s["peak_memory"] is None
                                   else round(s["peak_memory"] / 2**30, 3)),
               "rss_gib": {"start": round(rss[0][2] / 2**30, 3) if rss else None,
                           "iteration_500": None if at500 is None else round(at500 / 2**30, 3),
                           "end": round(rss[-1][2] / 2**30, 3) if rss else None,
                           "max": round(max(r for *_, r in rss) / 2**30, 3) if rss else None},
               "rss_growth_after_500_ok": (None if at500 is None or not rss else
                                           rss[-1][2] - at500 < RSS_GROWTH_MAX),
               **rss_profile(rss, s["start"], s["end"]),
               "stopped_at": s.get("stopped_at"),
               "launches": s["launches"], "derived": s["derived"],
               "launches_ok": (None if s["device"] != "cuda" else
                               (s["launches"]["k1"], s["launches"]["k2"])
                               == (s["derived"]["k1"], s["derived"]["k2"]))}
        out["segments"].append(seg)
    return out


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
    summary = {
        "config": f"configs/{STEM}.yaml", "sizes": dataclasses.asdict(sizes),
        "device": _device_line() if device == "cuda" else "cpu",
        "curves": {p: curve_summary(d) for p, d in curves.items()},
        "gen_against_ema": {"wins": families["wins"], "mean_fid": families["mean_fid"]},
        "against_recorded": {p: {"mean_fid": c["mean_fid"], "wins": c["wins"],
                                 "rows": c["rows"]} for p, c in against.items()},
        "classifier": inc, "calibrate": calib,
        "bars": {**check_bars(curves, inc.get("accuracy") if inc else None, calib),
                 **rules},
        "ema_wins_in_window": wins,
        "ema_from_live_rel_l2": {k: v for seg in (log or {}).get("segments", [])
                                 for k, v in seg.get("ema_from_live_rel_l2", {}).items()},
        "train": (train_summary(log, work.scalars, stamps, cfg.snapshot_save_iter)
                  if log else None),
        "curve_sweeps": _read(work.log("curves_log")),
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
        if snap.exists():
            path = docs / f"{best[0]}_a2b_test_hard_{best[1]['iteration']:08d}_small.jpg"
            summary["selected"]["grid"] = snapshot_grid(cfg, snap, path, device).name
        _write(docs / "summary.json", _relative(summary))
    _write(work.log("summary"), summary)
    _print_report(summary, curves, against)
    return summary


def _print_report(summary, curves, against) -> None:
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
        print(f"mean {s['mean_fid']}, best {s['best']}, lowest rate {s['min_rate']}")
    print("\nbars: " + json.dumps(summary["bars"]))


# ------------------------------------------------------------------ command line
SCORER_THREADS = 4  # OpenMP / BLAS threads of the `follow` process (its host sqrtm)


def run_alongside(work: Work, sizes: Sizes, args, recorded, docs) -> Dict[str, Any]:
    """`all` with the curves scored beside training: the dataset, then
    `follow` in a child process while `train` runs in this one, then
    `report`."""
    out = {"dataset": stage_dataset(work, sizes, args)}
    ensure_config(work, sizes)
    work.train_done.unlink(missing_ok=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "follow", "--work", str(work.root),
           "--device", args.device, "--data_root", str(work.data_root)]
    if args.smoke:
        cmd.append("--smoke")
    if args.inception_weights:
        cmd += ["--inception_weights", str(work.inception)]
    env = dict(os.environ, **{k: str(SCORER_THREADS) for k in (
        "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")})
    with open(work.root / "follow.log", "a") as log:
        child = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            out["train"] = stage_train(work, sizes, args)
        finally:
            work.train_done.write_text("")
            rc = child.wait()
    if rc:
        raise RuntimeError(f"the follow stage failed ({rc}); see {work.root / 'follow.log'}")
    out["report"] = report(work, sizes, recorded, docs, args.device)
    return out


def main(argv=None) -> Dict[str, Any]:
    t_start = time.time()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", nargs="?", default="all", choices=STAGES + ("all", "follow"))
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
    ap.add_argument("--deadline", type=float, default=None,
                    help="stop training after the last snapshot that lands within this "
                         "many seconds of the start")
    args = ap.parse_args(argv)
    args.stop_by = None if args.deadline is None else t_start + args.deadline
    from aclgan_tpu_torch.trainer import resolve_device

    resolve_device(args.device)
    sizes = SMOKE if args.smoke else FULL
    if args.iters is None:
        args.iters = sizes.iters
    work = Work.at(args.work, args.data_root, args.inception_weights)
    docs = work.root / "docs" if args.smoke else DOCS
    recorded = Path(args.recorded) if args.recorded else None if args.smoke else RECORDED
    stages = {"dataset": lambda: stage_dataset(work, sizes, args),
              "train": lambda: stage_train(work, sizes, args),
              "inception": lambda: stage_inception(work, sizes, args),
              "curves": lambda: stage_curves(work, sizes, args),
              "calibrate": lambda: stage_calibrate(work, sizes, args),
              "report": lambda: report(work, sizes, recorded, docs, args.device),
              "follow": lambda: stage_follow(work, sizes, args)}
    if args.stage == "all" and args.alongside:
        try:
            return run_alongside(work, sizes, args, recorded, docs)
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
    main()
