"""Helpers shared by the port's parity tests against the JAX package (not a
test module): a port model on the weights of a JAX `TrainState` (bn running
stats and sn u / v included), the z draws of a JAX step, and tree
comparisons. Everything runs on the CPU in float32."""

import numpy as np
import torch

import jax

from aclgan_tpu.utils.torch_import import map_discriminator_spectral, map_discriminator_stats
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.trainer import ACLGAN, DIS_NAMES, GEN_NAMES
from aclgan_tpu_torch.utils.jax_weights import (discriminator_params,
                                                discriminator_state_dict,
                                                generator_params, generator_state_dict)

BASE_KEY = jax.random.PRNGKey(42)
# whole-network movement rel-L2 bounds, generators / discriminators (measured
# at most 0.016 / 4.2e-5 in tests/test_torch_trainer.py); a discriminator with
# in / bn / ln layers gets
# the looser one: Adam's first step divides by |g| + eps, and where its
# second scale normalizes 2x2 rows the gradients sit near eps, so the step's
# size follows their float noise (measured 0.0016 under in)
MOVE_TOL = {"gen": 0.05, "dis": 1e-3, "normed dis": 1e-2}


def load_jax_discriminators(pm, state):
    params, spectral, stats = jax.device_get(
        (state.dis_params, state.dis_spectral, state.dis_stats))
    for n in DIS_NAMES:
        pm.dis(n).load_state_dict(discriminator_state_dict(
            params[n], pm.cfg.dis, spectral[n] or None, stats[n] or None))


def port_model(jm, state, seed=0):
    """A port model on the weights of a JAX TrainState. The generators load
    before `init_state`, so that the EMA starts from them."""
    pm = ACLGAN(from_dict(jm.cfg.to_dict()), device="cpu", seed=seed)
    gen_params = jax.device_get(state.gen_params)
    for n in GEN_NAMES:
        pm.gen(n).load_state_dict(generator_state_dict(gen_params[n], pm.cfg.gen))
    pm.init_state()
    load_jax_discriminators(pm, state)
    return pm


def jax_z(jm, it, batch=2, key=BASE_KEY):
    """The z the JAX train_step draws at global step `it`, for the port."""
    kd, kg = jax.random.split(jax.random.fold_in(key, it))
    return {"dis": [np.array(v) for v in jm._draw_z(kd, batch)],
            "gen": [np.array(v) for v in jm._draw_z(kg, batch)]}


def batches(n, batch=2, seed=23):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (batch, 16, 16, 3), dtype=np.uint8),
             rng.randint(0, 256, (batch, 16, 16, 3), dtype=np.uint8)) for _ in range(n)]


def rtol(key):
    # the focus size/digit terms are SUMS over every mask pixel; the
    # tolerances of tests/test_reference_parity.py:442-451
    return 3e-2 if key.endswith("_digit") else 1e-2 if "_focus_" in key else 2e-3


def assert_metrics(got, want):
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dim() == 0 and v.dtype == torch.float32 and not v.requires_grad, k
        np.testing.assert_allclose(float(v), float(want[k]), rtol=rtol(k), err_msg=k)


def flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def rel_l2(got, want):
    g, w = flat(got), flat(want)
    return np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)


def port_tree(pm, name, what="param"):
    """A port network's params (or grads) as the JAX param tree, through
    `utils/jax_weights.py`'s inverse maps (the JAX package's importer drops
    a discriminator's PReLU)."""
    if name in GEN_NAMES:
        net, mapper, cfg = pm.gen(name), generator_params, pm.cfg.gen
    else:
        net, mapper, cfg = pm.dis(name), discriminator_params, pm.cfg.dis
    sd = {k: (p.grad if what == "grad" else p).detach() for k, p in net.named_parameters()}
    return mapper(sd, cfg)


def _pre_norm_bias(path) -> bool:
    """A discriminator conv bias that an in / bn layer subtracts again: its
    gradient is float noise, which Adam's first step turns into +-lr in
    either framework."""
    keys = [getattr(k, "key", None) for k in path]
    return keys[-2:] == ["Conv_0", "bias"] and keys[-3] not in (None, "ConvBlock_0") \
        and str(keys[-3]).startswith("ConvBlock_")


def assert_moved_alike(pm, state0, state1):
    """Each network's parameter movement (state0 -> port now, against state0 ->
    state1 in JAX), whole-network rel-L2. Adam moves every leaf by about lr a
    step however small its gradient, so the leaves whose gradient is noise
    (a conv bias in front of an instance norm) move apart in the two
    frameworks; a semantic slip (decoupled L2, a schedule off by one, a G step
    on the stale D) moves whole networks apart. Under dis norm in / bn the
    conv biases those norms cancel are left out."""
    skip_bias = pm.cfg.dis.norm in ("in", "bn")
    for kind, names, field in (("gen", GEN_NAMES, "gen_params"),
                               ("dis", DIS_NAMES, "dis_params")):
        for n in names:
            init = jax.device_get(getattr(state0, field)[n])

            def moved(final):
                return jax.tree_util.tree_map_with_path(
                    lambda p, f, i: (np.zeros_like(np.asarray(i))
                                     if kind == "dis" and skip_bias and _pre_norm_bias(p)
                                     else np.asarray(f) - np.asarray(i)), final, init)

            err = rel_l2(moved(port_tree(pm, n)),
                         moved(jax.device_get(getattr(state1, field)[n])))
            tol = MOVE_TOL["normed dis" if kind == "dis" and pm.cfg.dis.norm in
                           ("in", "bn", "ln") else kind]
            assert err < tol, (n, err)


def assert_collections(pm, state, rtol=1e-3, atol=1e-6):
    """The port's sn u / v (v permuted to flax's order) or bn running stats
    against a JAX state's, through the JAX package's importers."""
    norm = pm.cfg.dis.norm
    if norm not in ("sn", "bn"):
        return 0
    mapper, want = ((map_discriminator_spectral, state.dis_spectral) if norm == "sn"
                    else (map_discriminator_stats, state.dis_stats))
    n_leaves = 0
    for n in DIS_NAMES:
        got = mapper(pm.dis(n).state_dict(), pm.cfg.dis)
        w = jax.device_get(want[n])
        for (path, g), (_, v) in zip(jax.tree_util.tree_leaves_with_path(got),
                                     jax.tree_util.tree_leaves_with_path(w)):
            np.testing.assert_allclose(np.asarray(g), np.asarray(v), rtol=rtol, atol=atol,
                                       err_msg=f"{n}{jax.tree_util.keystr(path)}")
            n_leaves += 1
    return n_leaves
