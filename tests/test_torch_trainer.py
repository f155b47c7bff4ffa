"""Port trainer (`aclgan_tpu_torch.trainer.ACLGAN`) against the JAX `ACLGAN`.

Both start from the same weights (the JAX `init_state`, carried across by
`aclgan_tpu_torch.utils.jax_weights`), see the same batches and the same z:
the JAX step derives its z from `fold_in(key, step)`, and the same draws
(`model._draw_z`) are handed to the port through `train_step(z=...)`.
Everything is float32 on the CPU, at `tests/helpers.py::tiny_config` scale.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclgan_tpu.trainer import ACLGAN as JACLGAN
from aclgan_tpu.trainer import to_model_range as jto_model_range
from aclgan_tpu.utils.torch_import import (map_discriminator_state_dict,
                                           map_generator_state_dict)
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.trainer import ACLGAN, DIS_NAMES, GEN_NAMES
from aclgan_tpu_torch.utils.jax_weights import (discriminator_state_dict,
                                                generator_state_dict)
from tests.helpers import tiny_config

BASE_KEY = jax.random.PRNGKey(42)
# whole-network movement rel-L2 bounds, generators / discriminators: measured
# at most 0.016 / 4.2e-5 (see _assert_moved_alike)
MOVE_TOL = {"gen": 0.05, "dis": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the test workers share the
    cores (eight threads a worker oversubscribe them many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**overrides):
    """tiny_config with alpha 0.7 (exercises alpha * z2) and wd > 0 (coupled L2
    is observable), plus the overrides."""
    return tiny_config(alpha=0.7, weight_decay=1e-4, **overrides)


def _pair(jcfg, seed=0):
    """(JAX model, its initial TrainState, the port model on the same weights)."""
    jm = JACLGAN(jcfg)
    state = jm.init_state(jax.random.PRNGKey(seed), (16, 16))
    return jm, state, _port(jm, state, seed)


def _port(jm, state, seed=0):
    """A port model on the weights of a JAX TrainState. The generators are
    loaded before `init_state`, so that the EMA starts from them."""
    pm = ACLGAN(from_dict(jm.cfg.to_dict()), device="cpu", seed=seed)
    gen_params = jax.device_get(state.gen_params)
    dis_params = jax.device_get(state.dis_params)
    for n in GEN_NAMES:
        pm.gen(n).load_state_dict(generator_state_dict(gen_params[n], pm.cfg.gen))
    pm.init_state()
    for n in DIS_NAMES:
        pm.dis(n).load_state_dict(discriminator_state_dict(dis_params[n], pm.cfg.dis))
    return pm


def _batches(n, seed=23):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (2, 16, 16, 3), dtype=np.uint8),
             rng.randint(0, 256, (2, 16, 16, 3), dtype=np.uint8)) for _ in range(n)]


def _z(jm, it, batch=2):
    """The z the JAX train_step draws at global step `it`, for the port."""
    kd, kg = jax.random.split(jax.random.fold_in(BASE_KEY, it))
    return {"dis": [np.array(v) for v in jm._draw_z(kd, batch)],
            "gen": [np.array(v) for v in jm._draw_z(kg, batch)]}


def _rtol(key):
    # the focus size/digit terms are SUMS over every mask pixel; the
    # tolerances of tests/test_reference_parity.py:442-451
    return 3e-2 if key.endswith("_digit") else 1e-2 if "_focus_" in key else 2e-3


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dim() == 0 and v.dtype == torch.float32 and not v.requires_grad, k
        np.testing.assert_allclose(float(v), float(want[k]), rtol=_rtol(k), err_msg=k)


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _rel_l2(got, want):
    g, w = _flat(got), _flat(want)
    return np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)


def _port_tree(pm, name, what="param"):
    """A port network's params (or grads) as the JAX param tree."""
    if name in GEN_NAMES:
        net, mapper, cfg = pm.gen(name), map_generator_state_dict, pm.cfg.gen
    else:
        net, mapper, cfg = pm.dis(name), map_discriminator_state_dict, pm.cfg.dis
    sd = {k: (p.grad if what == "grad" else p).detach() for k, p in net.named_parameters()}
    return mapper(sd, cfg)


def _moved(final, initial):
    return jax.tree_util.tree_map(lambda f, i: np.asarray(f) - np.asarray(i),
                                  final, initial)


def _assert_moved_alike(pm, state0, state1):
    """Each network's parameter movement (state0 -> port now, against state0 ->
    state1 in JAX), whole-network rel-L2. Adam moves every leaf by about lr a
    step however small its gradient, so the leaves whose gradient is noise
    (a conv bias in front of an instance norm) move apart in the two
    frameworks; a semantic slip (decoupled L2, a schedule off by one, a G step
    on the stale D) moves whole networks apart."""
    for kind, names, field in (("gen", GEN_NAMES, "gen_params"),
                               ("dis", DIS_NAMES, "dis_params")):
        for n in names:
            init = jax.device_get(getattr(state0, field)[n])
            err = _rel_l2(_moved(_port_tree(pm, n), init),
                          _moved(jax.device_get(getattr(state1, field)[n]), init))
            assert err < MOVE_TOL[kind], (n, err)


@pytest.fixture(scope="module")
def smooth():
    """focus_delta 0, focus_epsilon 10: the focus terms' gradients are well
    conditioned (tests/test_reference_parity.py:487-496 explains why);
    step_size 4 puts StepLR boundaries at iterations 4 and 8."""
    return _pair(_config(focus_delta=0.0, focus_epsilon=10.0, step_size=4, gamma=0.5))


@pytest.mark.parametrize("variant", ["focus_ema", "no_focus"])
def test_one_iteration_matches_jax(variant):
    """One D step then one G step (the G step sees the stepped D): metric keys
    and values, every network's weights after the step, and the EMA."""
    if variant == "focus_ema":
        jcfg = _config(tpu=dataclasses.replace(tiny_config().tpu, ema_decay=0.999))
    else:
        jcfg = _config(focus_loss=0.0)
        jcfg.gen.output_dim = 3
    jm, state, pm = _pair(jcfg, seed=1)
    (xa, xb), = _batches(1, seed=5)
    new_state, want = jm.train_step(state, jnp.asarray(xa), jnp.asarray(xb), BASE_KEY,
                                    True, True)
    got = pm.train_step(xa, xb, True, True, z=_z(jm, 0))
    _assert_metrics(got, want)
    assert ("loss_gen_focus_A_size" in got) == (variant == "focus_ema")
    assert pm.step == int(new_state.step) == 1
    _assert_moved_alike(pm, state, new_state)
    for n in DIS_NAMES:
        assert all(p.grad is not None for p in pm.dis(n).parameters())
    if variant == "no_focus":
        assert pm.ema is None and new_state.ema_params is None
        return
    ema = jax.device_get(new_state.ema_params)
    for n in GEN_NAMES:
        got_ema = map_generator_state_dict(pm.ema[n], pm.cfg.gen)
        assert _rel_l2(got_ema, ema[n]) < 1e-6, n
        live = dict(pm.gen(n).named_parameters())
        assert all(t.data_ptr() != live[k].data_ptr() for k, t in pm.ema[n].items())


def test_gradients_of_all_five_networks_match_jax(smooth):
    jm, state, pm = smooth
    (xa, xb), = _batches(1, seed=7)
    z = _z(jm, 0)["gen"]
    ja, jb = (jto_model_range(jnp.asarray(v)) for v in (xa, xb))
    jz = tuple(jnp.asarray(v) for v in z)
    spectral = stats = {"A": {}, "B": {}, "2": {}}

    fwd = jm.generator_forward(state.gen_params, ja, jb, *jz, with_recon=False)
    d_grads = jax.jit(jax.grad(lambda p: jm._dis_loss_fn(
        p, spectral, stats, fwd, ja, jb)[0]))(state.dis_params)
    g_grads = jax.jit(jax.grad(lambda p: jm._gen_loss_fn(
        p, state.dis_params, spectral, stats, ja, jb, *jz)[0]))(state.gen_params)

    xa_t, xb_t = pm._images(xa), pm._images(xb)
    zt = tuple(torch.from_numpy(v) for v in z)
    with torch.no_grad():
        pfwd = pm.generator_forward(xa_t, xb_t, *zt, with_recon=False)
    pm._dis_loss(pfwd, xa_t, xb_t)[0].backward()
    total, _ = pm._gen_loss(xa_t, xb_t, zt)
    for p, g in zip(pm.gen_params, torch.autograd.grad(total, pm.gen_params)):
        p.grad = g
    for n in DIS_NAMES:
        assert _rel_l2(_port_tree(pm, n, "grad"), jax.device_get(d_grads[n])) < 1e-3, n
    for n in GEN_NAMES:
        assert _rel_l2(_port_tree(pm, n, "grad"), jax.device_get(g_grads[n])) < 1e-3, n


def test_ten_iteration_trajectory_matches_jax(smooth):
    """The shipped D1/G2 cadence over 10 iterations, crossing the StepLR
    boundaries at 4 and 8: losses, learning rates and each network's total
    parameter movement (Adam with coupled L2, the G step on the stepped D)."""
    jm, state0, _ = smooth
    pm = _port(jm, state0)
    state = state0
    batches = _batches(10)
    j_loss, p_loss, j_lr, p_lr = [], [], [], []
    for it, (xa, xb) in enumerate(batches):
        do_gen = it % 2 == 0
        j_lr.append(float(jm.learning_rate(state.step)))
        p_lr.append(pm.learning_rate(pm.step))
        state, jmet = jm.train_step(state, jnp.asarray(xa), jnp.asarray(xb), BASE_KEY,
                                    True, do_gen)
        pmet = pm.train_step(xa, xb, True, do_gen, z=_z(jm, it))
        keys = ["loss_dis_total"] + (["loss_gen_total"] if do_gen else [])
        assert set(pmet) == set(jmet)
        j_loss.append([float(jmet[k]) for k in keys])
        p_loss.append([float(pmet[k]) for k in keys])
    np.testing.assert_allclose(p_lr, j_lr, rtol=1e-6)
    assert p_lr[0] == pytest.approx(1e-4) and p_lr[-1] == pytest.approx(0.25e-4)
    np.testing.assert_allclose(sum(p_loss, []), sum(j_loss, []), rtol=2e-3)
    assert pm.step == int(state.step) == 10
    _assert_moved_alike(pm, state0, state)


def test_step_increment_and_own_noise():
    """Skipped iterations advance the step (and the lr); without z the port
    draws its own, reproducibly from the seed; metrics come back detached."""
    cfg = from_dict(_config(step_size=2).to_dict())
    runs = []
    for _ in range(2):
        pm = ACLGAN(cfg, device="cpu", seed=3)
        pm.init_state()
        xa, xb = _batches(1)[0]
        m = pm.train_step(xa, xb, True, False, step_increment=3)
        assert pm.step == 3  # the update ran at global step 2: one StepLR decay
        assert pm.dis_opt.param_groups[0]["lr"] == pytest.approx(0.5e-4)
        assert not m["loss_dis_total"].requires_grad
        runs.append(float(m["loss_dis_total"]))
    assert runs[0] == runs[1]


def test_gen_step_takes_no_discriminator_gradients():
    """A G step alone fills the generators' .grad and leaves the
    discriminators' untouched (their weight gradients are never computed)."""
    pm = ACLGAN(from_dict(_config().to_dict()), device="cpu")
    pm.init_state()
    xa, xb = _batches(1)[0]
    pm.train_step(xa, xb, False, True)
    assert all(p.grad is not None for p in pm.gen_params)
    assert all(p.grad is None for p in pm.dis_params)


@pytest.mark.parametrize("variant", ["focus_float_input", "no_focus_uint8_input"])
def test_sample_matches_jax(variant):
    """The display rows: the focus 9-tuple or the non-focus 7-tuple, NHWC
    float32, from [-1, 1] floats (as the train CLI's display batches are) or
    uint8 images."""
    focus = variant.startswith("focus")
    jcfg = _config() if focus else _config(focus_loss=0.0)
    if not focus:
        jcfg.gen.output_dim = 3
    jm, state, pm = _pair(jcfg, seed=2)
    xa, xb = _batches(1, seed=8)[0]
    if focus:
        xa, xb = (v.astype(np.float32) * (2.0 / 255.0) - 1.0 for v in (xa, xb))
    rng = np.random.RandomState(4)
    z = [rng.randn(2, jcfg.gen.style_dim).astype(np.float32) for _ in range(3)]
    want = jm.sample(state.gen_params, jnp.asarray(xa), jnp.asarray(xb),
                     *(jnp.asarray(v) for v in z))
    got = pm.sample(xa, xb, *z)
    assert len(got) == len(want) == (9 if focus else 7)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=str(i))


@pytest.mark.parametrize("tpu_change,match", [
    (dict(grad_accum=2), "grad_accum"),
    (dict(remat=True), "remat"),
    (dict(moment_dtype="bfloat16"), "moment_dtype"),
])
def test_unported_train_options_raise(tpu_change, match):
    cfg = from_dict(tiny_config().to_dict())
    cfg.tpu = dataclasses.replace(cfg.tpu, **tpu_change)
    pm = ACLGAN(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        pm.init_state()
