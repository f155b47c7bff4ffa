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

Snapshot sets of the JAX package load too, through `utils/msgpack.py` and
`utils/jax_weights.py`: `gen_/dis_/ema_%08d.msgpack` (flax params; dis
`{'params', 'spectral'[, 'batch_stats']}`) and `optimizer.msgpack` (`{'gen',
'dis', 'step'[, 'saved_iteration'][, 'rng']}`, optax Adam states whose `mu` /
`nu` become `exp_avg` / `exp_avg_sq` by parameter name and whose `count`
becomes each parameter's `step`), with the JAX loader's checks. The JAX `rng`
is a threefry key that cannot seed the port's z generator: a `.msgpack` resume
restarts the z stream from (seed, step). A directory holding both kinds
resumes from the newer set; after the port's first snapshot that is its
`.pt` set. `list_snapshots` finds generator files of both kinds.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from aclgan_tpu_torch.trainer import DIS_NAMES, GEN_NAMES
from aclgan_tpu_torch.utils.jax_weights import (discriminator_collections,
                                                discriminator_params,
                                                discriminator_state_dict,
                                                generator_params, generator_state_dict)
from aclgan_tpu_torch.utils.msgpack import dumps, read_msgpack

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


def save_discriminators(path: str, model) -> None:
    """Write `model.dis_A` / `dis_B` / `dis_2` (buffers included) atomically."""
    _atomic_save({k: model.dis(k).state_dict() for k in DIS_NAMES}, path)


def _generator_state_dicts(path: str, model) -> Dict[str, Any]:
    """`{'AB', 'BA'}` state dicts from the port's `.pt` or a JAX `.msgpack`."""
    if path.endswith(".msgpack"):
        tree = _numpy(read_msgpack(path))
        return {k: generator_state_dict(tree[k], model.cfg.gen) for k in GEN_NAMES}
    if path.endswith((".pt", ".pth")):
        return _load(path)
    raise ValueError(f"{path}: the port reads .pt or .msgpack generator checkpoints")


def _discriminator_state_dicts(path: str, model) -> Dict[str, Any]:
    """`{'A', 'B', '2'}` state dicts from the port's or the reference's `.pt`,
    or a JAX `.msgpack` (`{'params', 'spectral'[, 'batch_stats']}`), bn stats
    and sn u / v included; a file of another dis.norm than bn's raises."""
    cfg = model.cfg.dis
    if path.endswith(".msgpack"):
        tree = _numpy(read_msgpack(path))
        _check_stats(model, path, "batch_stats" in tree)
        spectral = tree["spectral"] if cfg.norm == "sn" else None
        stats = tree.get("batch_stats")
        return {k: discriminator_state_dict(tree["params"][k], cfg,
                                            None if spectral is None else spectral[k],
                                            None if stats is None else stats[k])
                for k in DIS_NAMES}
    if path.endswith((".pt", ".pth")):
        sds = _load(path)
        _check_stats(model, path, any(k.endswith(".running_mean") for k in sds[DIS_NAMES[0]]))
        return sds
    raise ValueError(f"{path}: the port reads .pt or .msgpack discriminator checkpoints")


def load_generators(path: str, model) -> None:
    """Load a `{'AB', 'BA'}` generator checkpoint into `model`'s generators:
    the port's `.pt`, or the JAX package's flax `.msgpack`."""
    sds = _generator_state_dicts(path, model)
    for k in GEN_NAMES:
        model.gen(k).load_state_dict(sds[k])


def load_discriminators(path: str, model) -> None:
    """Load a `{'A', 'B', '2'}` discriminator checkpoint into `model` (after
    `init_state`), as `_discriminator_state_dicts` reads it."""
    sds = _discriminator_state_dicts(path, model)
    for k in DIS_NAMES:
        model.dis(k).load_state_dict(sds[k])


def _numpy(tree: Any) -> Any:
    """Tensors of a nested dict as float32 numpy arrays (bf16 included)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.float().numpy() if isinstance(tree, torch.Tensor) else tree


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


def _write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _jax_adam_tree(model, key: str, nets, to_tree) -> Dict[str, Any]:
    """`model.{key}_opt` as optax's Adam state over the flax trees of `nets`:
    {count, mu, nu}, inside {'0': {}, '1': ...} when weight decay is on."""
    opt = getattr(model, f"{key}_opt")
    mu_dtype = torch.bfloat16 if model.cfg.tpu.moment_dtype == "bfloat16" else torch.float32
    count, mu, nu = 0, {}, {}
    for n, net in nets.items():
        mu_sd, nu_sd = {}, {}
        for k, p in net.named_parameters():
            st = opt.state.get(p, {})
            count = int(st["step"]) if st else count
            mu_sd[k] = st["exp_avg"].to(mu_dtype) if st else torch.zeros_like(p, dtype=mu_dtype)
            nu_sd[k] = st["exp_avg_sq"] if st else torch.zeros_like(p)
        mu[n], nu[n] = to_tree(mu_sd), to_tree(nu_sd)
    adam = {"count": torch.tensor(count, dtype=torch.int32), "mu": mu, "nu": nu}
    return {"0": {}, "1": adam} if model.cfg.weight_decay > 0 else adam


def save_jax_checkpoint(snapshot_dir: str, model, iterations: int) -> None:
    """Write `model`'s state as the JAX package's snapshot set
    (`aclgan_tpu/utils/checkpoint.py::save_checkpoint`), stamped iterations + 1:
    `gen_/dis_[/ema_]%08d.msgpack` and `optimizer.msgpack` without an `rng`
    (the z generator has no threefry key). It serves tests and `chip_smoke.py`,
    which make a JAX-layout set where JAX is absent."""
    os.makedirs(snapshot_dir, exist_ok=True)
    cfg, stamp = model.cfg, iterations + 1
    gens = {n: model.gen(n) for n in GEN_NAMES}
    dises = {n: model.dis(n) for n in DIS_NAMES}

    def gen_tree(sd):
        return generator_params(sd, cfg.gen)

    def dis_tree(sd):
        return discriminator_params(sd, cfg.dis)

    def path(name):
        return os.path.join(snapshot_dir, name)

    _write(path("gen_%08d.msgpack" % stamp),
           dumps({n: gen_tree(g.state_dict()) for n, g in gens.items()}))
    sds = {n: d.state_dict() for n, d in dises.items()}
    collections = {n: discriminator_collections(sd, cfg.dis) for n, sd in sds.items()}
    dis = {"params": {n: dis_tree(sd) for n, sd in sds.items()},
           "spectral": {n: c[0] for n, c in collections.items()}}
    if cfg.dis.norm == "bn":
        dis["batch_stats"] = {n: c[1] for n, c in collections.items()}
    _write(path("dis_%08d.msgpack" % stamp), dumps(dis))
    if model.ema is not None:
        _write(path("ema_%08d.msgpack" % stamp),
               dumps({n: gen_tree(model.ema[n]) for n in GEN_NAMES}))
    _write(path("optimizer.msgpack"), dumps({
        "gen": _jax_adam_tree(model, "gen", gens, gen_tree),
        "dis": _jax_adam_tree(model, "dis", dises, dis_tree),
        "step": torch.tensor(model.step, dtype=torch.int32),
        "saved_iteration": np.int32(stamp)}))


def get_model_list(dirname: str, key: str, suffix: str = ".pt") -> Optional[str]:
    """Lexicographic-latest `suffix` checkpoint whose name contains `key`."""
    if not os.path.exists(dirname):
        return None
    models = [os.path.join(dirname, f) for f in os.listdir(dirname)
              if os.path.isfile(os.path.join(dirname, f))
              and key in f and f.endswith(suffix) and f != "optimizer" + suffix]
    if not models:
        return None
    return sorted(models)[-1]


def parse_iteration(path: str) -> int:
    """gen_%08d.pt (or .msgpack) -> iteration."""
    stem = os.path.basename(path).split(".")[0]
    return int(stem.split("_")[-1])


def _mismatch(checkpoint_dir: str, what: str) -> RuntimeError:
    return RuntimeError(f"Snapshot set mismatch in {checkpoint_dir}: {what}")


def _newest_gen(checkpoint_dir: str) -> str:
    """The newest generator file of the `.pt` and the `.msgpack` sets; both at
    one iteration is ambiguous and raises."""
    found = [p for p in (get_model_list(checkpoint_dir, "gen", sfx) for sfx in GEN_SUFFIXES)
             if p is not None]
    if not found:
        raise FileNotFoundError(f"No gen checkpoint in {checkpoint_dir}")
    if len(found) == 2 and parse_iteration(found[0]) == parse_iteration(found[1]):
        raise RuntimeError(
            f"Ambiguous snapshot sets in {checkpoint_dir}: {os.path.basename(found[0])} and "
            f"{os.path.basename(found[1])} are both iteration {parse_iteration(found[0])}; "
            "move one set away")
    return max(found, key=parse_iteration)


def _check_stats(model, dis_path: str, has_stats: bool) -> None:
    """The bn checkpoint/config check of `aclgan_tpu/utils/checkpoint.py:145-154`."""
    want_stats = model.cfg.dis.norm == "bn"
    if want_stats != has_stats:
        raise RuntimeError(
            f"Checkpoint/config mismatch in {os.path.dirname(dis_path) or '.'}: the config "
            f"{'expects' if want_stats else 'does not expect'} bn running stats "
            f"(dis.norm='bn') but {os.path.basename(dis_path)} "
            f"{'has none' if want_stats else 'contains batch_stats'} — the snapshot "
            "was written under a different dis.norm")


def _jax_adam(tree: Dict[str, Any]) -> Dict[str, Any]:
    """optax's Adam state in a flax state dict: `chain(add_decayed_weights,
    scale_by_adam)` is {'0': {}, '1': {count, mu, nu}}, a bare
    `scale_by_adam` {count, mu, nu}."""
    return tree["1"] if "1" in tree else tree


def _adam_state_dict(opt: torch.optim.Optimizer, nets, moments, count: int) -> Dict[str, Any]:
    """An optimizer state dict over the parameters of `nets`, in their order:
    `moments` holds (exp_avg, exp_avg_sq) state dicts per net, by parameter name."""
    state, idx = {}, 0
    for net, (mu, nu) in zip(nets, moments):
        names = [k for k, _ in net.named_parameters()]
        if set(mu) != set(names) or set(nu) != set(names):
            raise KeyError(f"optimizer moments: keys {sorted(set(mu) ^ set(names))[:5]} "
                           "differ from the network's parameters")
        for k in names:
            state[idx] = {"step": torch.tensor(float(count)), "exp_avg": mu[k],
                          "exp_avg_sq": nu[k]}
            idx += 1
    return {"state": state, "param_groups": opt.state_dict()["param_groups"]}


def _load_msgpack_optimizer(model, opt: Dict[str, Any], snap: Dict[str, Any]) -> None:
    cfg = model.cfg
    for key, nets, names, to_sd in (
            ("gen", [model.gen(n) for n in GEN_NAMES], GEN_NAMES,
             lambda t: generator_state_dict(t, cfg.gen)),
            ("dis", [model.dis(n) for n in DIS_NAMES], DIS_NAMES,
             lambda t: discriminator_state_dict(t, cfg.dis))):
        adam = _jax_adam(opt[key])
        moments = [(to_sd(adam["mu"][n]), to_sd(adam["nu"][n])) for n in names]
        snap[f"{key}_opt"] = _adam_state_dict(getattr(model, f"{key}_opt"), nets, moments,
                                              int(adam["count"]))
    snap["step"] = int(opt["step"])


def load_checkpoint(checkpoint_dir: str, model) -> int:
    """Restore `model` (an `ACLGAN` after `init_state`) from the newest
    snapshot set in `checkpoint_dir`, the port's or the JAX package's;
    returns its iteration."""
    gen_path = _newest_gen(checkpoint_dir)
    suffix = os.path.splitext(gen_path)[1]
    jax_set = suffix == ".msgpack"
    iterations = parse_iteration(gen_path)
    dis_path = get_model_list(checkpoint_dir, "dis", suffix)
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
    snap = {"ema": None, "gen_opt": None, "dis_opt": None, "step": iterations, "rng": None}
    snap.update(gen=_generator_state_dicts(gen_path, model),
                dis=_discriminator_state_dicts(dis_path, model))

    if model.ema is not None:
        ema_path = get_model_list(checkpoint_dir, "ema", suffix)
        if ema_path is not None and parse_iteration(ema_path) == iterations:
            snap["ema"] = _generator_state_dicts(ema_path, model)
        else:  # EMA turned on mid-run, or its file pruned
            print(f"No ema checkpoint for iteration {iterations} in {checkpoint_dir}; "
                  "seeding EMA from the gen weights")

    opt_name = "optimizer" + suffix
    opt_path = os.path.join(checkpoint_dir, opt_name)
    if os.path.exists(opt_path):
        opt = _numpy(read_msgpack(opt_path)) if jax_set else _load(opt_path)
        # a JAX optimizer file from before the stamp has none (still loads)
        if "saved_iteration" in opt and int(opt["saved_iteration"]) != iterations:
            raise _mismatch(checkpoint_dir, (
                f"{opt_name} was written at iteration {int(opt['saved_iteration'])} "
                f"but the newest gen/dis files are iteration {iterations} — likely a "
                f"crash between snapshot writes; delete the orphaned newer gen/dis "
                f"files (or restore a matching optimizer) to resume from a consistent "
                f"set"))
        if jax_set:
            _load_msgpack_optimizer(model, opt, snap)
        else:
            snap.update(gen_opt=opt["gen"], dis_opt=opt["dis"], step=opt["step"],
                        rng=opt["rng"])
    elif os.path.exists(os.path.join(checkpoint_dir, "imported.marker")):
        # imported reference weights ship no optimizer file: fresh moments,
        # the step from the file name
        print(f"No {opt_name} in {checkpoint_dir}; starting with fresh optimizer "
              "moments (imported.marker)")
    else:
        raise _mismatch(checkpoint_dir, (
            f"gen/dis checkpoints exist but {opt_name} does not — likely a crash "
            "between the dis and optimizer writes of the first snapshot. If this "
            "directory holds deliberately imported weights (fresh optimizer "
            "intended), create an empty 'imported.marker' file next to them; "
            "otherwise delete the torn snapshot files"))
    model.restore(snap)
    if jax_set:
        model.reseed_z(model.step)
        print(f"Resumed a JAX snapshot set: its threefry key cannot seed the z "
              f"generator; the z stream restarts from (seed {model.seed}, step "
              f"{model.step})")
    return iterations


def resume(checkpoint_dir: str, model) -> int:
    iterations = load_checkpoint(checkpoint_dir, model)
    print(f"Resume from iteration {iterations}")
    return iterations
