"""Checkpoint save / discovery / resume in `.pt` files.

The contract of `aclgan_tpu/utils/checkpoint.py`, in the reference's `.pt`
layout, so that `aclgan_tpu.utils.torch_import` (and `aclgan_tpu.cli.convert`)
read port snapshots unchanged:

- `gen_%08d.pt` holds `{'AB', 'BA'}` generator state dicts, `dis_%08d.pt`
  `{'A', 'B', '2'}` discriminator state dicts (reference key names), and
  `ema_%08d.pt` the EMA generators as `{'AB', 'BA'}` when `tpu.ema_decay > 0`;
  each is stamped iterations + 1.
- One rewritten `optimizer.pt` holds `{'gen', 'dis', 'step',
  'saved_iteration', 'rng'}`: both Adams' `state_dict()`, the global step,
  the stamp of the snapshot set it closes, and the z generator's state, so a
  resumed run draws the same z as an uninterrupted one.
- Writes are atomic (`os.replace`) and go gen, dis, ema, then optimizer: the
  optimizer file is the set's commit point, and `load_checkpoint` refuses a
  set that a crash left mixed.
- Discovery is lexicographic-latest on the key substring, never
  `optimizer.pt`; the iteration is parsed from the file name.

Generator files of the JAX package (`gen_/ema_%08d.msgpack`, `{'AB', 'BA'}`
flax params) load too, through `utils/msgpack.py` and
`utils/jax_weights.py`, and `list_snapshots` finds them beside `.pt` ones.
Resuming a JAX run (its `dis_` and `optimizer.msgpack`) is not ported.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import torch

from aclgan_tpu_torch.trainer import GEN_NAMES
from aclgan_tpu_torch.utils.jax_weights import generator_state_dict
from aclgan_tpu_torch.utils.msgpack import read_msgpack

GEN_SUFFIXES = (".pt", ".msgpack")  # the port's snapshots, the JAX package's


def _cpu(obj: Any) -> Any:
    """Tensors of a nested dict/list/tuple moved to the CPU, for the file."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(_cpu(obj), tmp)
    os.replace(tmp, path)


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_generators(path: str, model) -> None:
    """Write `model.gen_AB` / `model.gen_BA` to `path` atomically."""
    _atomic_save({k: model.gen(k).state_dict() for k in GEN_NAMES}, path)


def load_generators(path: str, model) -> None:
    """Load a `{'AB', 'BA'}` generator checkpoint into `model`'s generators:
    the port's `.pt`, or the JAX package's flax `.msgpack`."""
    if path.endswith(".msgpack"):
        tree = read_msgpack(path)
        ckpt = {k: generator_state_dict(_numpy(tree[k]), model.cfg.gen) for k in GEN_NAMES}
    elif path.endswith((".pt", ".pth")):
        ckpt = _load(path)
    else:
        raise ValueError(f"{path}: the port reads .pt or .msgpack generator checkpoints")
    for k in GEN_NAMES:
        model.gen(k).load_state_dict(ckpt[k])


def _numpy(tree: Any) -> Any:
    """Tensors of a nested dict as float32 numpy arrays (bf16 included)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.float().numpy()


def list_snapshots(checkpoint_dir: str, prefix: str) -> List[str]:
    """The `<prefix>_%08d` generator files (`.pt` or `.msgpack`) in
    `checkpoint_dir`, sorted by name; symlinks (aliases) left out."""
    names = [f for f in os.listdir(checkpoint_dir)
             if f.startswith(prefix + "_") and f.endswith(GEN_SUFFIXES)]
    paths = [os.path.join(checkpoint_dir, f) for f in sorted(names)]
    return [p for p in paths if os.path.isfile(p) and not os.path.islink(p)]


def save_checkpoint(snapshot_dir: str, model, iterations: int, keep: int = 0) -> None:
    """Write the snapshot set of `model` (an `ACLGAN` after `init_state`) for
    `iterations`, stamped iterations + 1. keep > 0 prunes the gen, dis and
    ema files to the newest `keep` of each."""
    os.makedirs(snapshot_dir, exist_ok=True)
    snap = model.snapshot()
    stamp = iterations + 1
    _atomic_save(snap["gen"], os.path.join(snapshot_dir, "gen_%08d.pt" % stamp))
    _atomic_save(snap["dis"], os.path.join(snapshot_dir, "dis_%08d.pt" % stamp))
    if snap["ema"] is not None:
        _atomic_save(snap["ema"], os.path.join(snapshot_dir, "ema_%08d.pt" % stamp))
    _atomic_save({"gen": snap["gen_opt"], "dis": snap["dis_opt"], "step": snap["step"],
                  "saved_iteration": stamp, "rng": snap["rng"]},
                 os.path.join(snapshot_dir, "optimizer.pt"))
    if keep > 0:
        for prefix in ("gen", "dis", "ema"):
            snaps = sorted(f for f in os.listdir(snapshot_dir)
                           if f.startswith(prefix + "_") and f.endswith(".pt"))
            for old in snaps[:-keep]:
                os.remove(os.path.join(snapshot_dir, old))


def get_model_list(dirname: str, key: str) -> Optional[str]:
    """Lexicographic-latest `.pt` checkpoint whose name contains `key`."""
    if not os.path.exists(dirname):
        return None
    models = [os.path.join(dirname, f) for f in os.listdir(dirname)
              if os.path.isfile(os.path.join(dirname, f))
              and key in f and f.endswith(".pt") and f != "optimizer.pt"]
    if not models:
        return None
    return sorted(models)[-1]


def parse_iteration(path: str) -> int:
    """gen_%08d.pt (or .msgpack) -> iteration."""
    stem = os.path.basename(path).split(".")[0]
    return int(stem.split("_")[-1])


def _mismatch(checkpoint_dir: str, what: str) -> RuntimeError:
    return RuntimeError(f"Snapshot set mismatch in {checkpoint_dir}: {what}")


def load_checkpoint(checkpoint_dir: str, model) -> int:
    """Restore `model` (an `ACLGAN` after `init_state`) from the newest
    snapshot set in `checkpoint_dir`; returns its iteration."""
    gen_path = get_model_list(checkpoint_dir, "gen")
    if gen_path is None:
        raise FileNotFoundError(f"No gen checkpoint in {checkpoint_dir}")
    iterations = parse_iteration(gen_path)
    dis_path = get_model_list(checkpoint_dir, "dis")
    if dis_path is None:
        raise _mismatch(checkpoint_dir, (
            f"found {os.path.basename(gen_path)} but no dis checkpoint at all — likely "
            f"a crash between snapshot writes; delete the orphaned gen file (or the "
            f"whole directory) to start fresh"))
    if parse_iteration(dis_path) != iterations:
        raise _mismatch(checkpoint_dir, (
            f"newest gen is iteration {iterations} ({os.path.basename(gen_path)}) but "
            f"newest dis is iteration {parse_iteration(dis_path)} "
            f"({os.path.basename(dis_path)}) — likely a crash between snapshot writes; "
            f"delete the orphaned newer file to resume from the last complete set"))
    snap = {"gen": _load(gen_path), "dis": _load(dis_path), "ema": None,
            "gen_opt": None, "dis_opt": None, "step": iterations, "rng": None}

    if model.ema is not None:
        ema_path = get_model_list(checkpoint_dir, "ema")
        if ema_path is not None and parse_iteration(ema_path) == iterations:
            snap["ema"] = _load(ema_path)
        else:  # EMA turned on mid-run, or its file pruned
            print(f"No ema checkpoint for iteration {iterations} in {checkpoint_dir}; "
                  "seeding EMA from the gen weights")

    opt_path = os.path.join(checkpoint_dir, "optimizer.pt")
    if os.path.exists(opt_path):
        opt = _load(opt_path)
        if int(opt["saved_iteration"]) != iterations:
            raise _mismatch(checkpoint_dir, (
                f"optimizer.pt was written at iteration {int(opt['saved_iteration'])} "
                f"but the newest gen/dis files are iteration {iterations} — likely a "
                f"crash between snapshot writes; delete the orphaned newer gen/dis "
                f"files (or restore a matching optimizer) to resume from a consistent "
                f"set"))
        snap.update(gen_opt=opt["gen"], dis_opt=opt["dis"], step=opt["step"],
                    rng=opt["rng"])
    elif os.path.exists(os.path.join(checkpoint_dir, "imported.marker")):
        # imported reference weights ship no optimizer file: fresh moments,
        # the step from the file name
        print(f"No optimizer.pt in {checkpoint_dir}; starting with fresh optimizer "
              "moments (imported.marker)")
    else:
        raise _mismatch(checkpoint_dir, (
            "gen/dis checkpoints exist but optimizer.pt does not — likely a crash "
            "between the dis and optimizer writes of the first snapshot. If this "
            "directory holds deliberately imported weights (fresh optimizer "
            "intended), create an empty 'imported.marker' file next to them; "
            "otherwise delete the torn snapshot files"))
    model.restore(snap)
    return iterations


def resume(checkpoint_dir: str, model) -> int:
    iterations = load_checkpoint(checkpoint_dir, model)
    print(f"Resume from iteration {iterations}")
    return iterations
