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
from aclgan_tpu.utils.torch_import import map_generator_state_dict
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.trainer import ACLGAN, DIS_NAMES, GEN_NAMES
from tests.helpers import tiny_config
from tests.torch_parity import (BASE_KEY, MOVE_TOL, assert_metrics, assert_moved_alike,
                                batches, flat, jax_z, port_model, port_tree, rel_l2)


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
    return jm, state, port_model(jm, state, seed)


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
    (xa, xb), = batches(1, seed=5)
    new_state, want = jm.train_step(state, jnp.asarray(xa), jnp.asarray(xb), BASE_KEY,
                                    True, True)
    got = pm.train_step(xa, xb, True, True, z=jax_z(jm, 0))
    assert_metrics(got, want)
    assert ("loss_gen_focus_A_size" in got) == (variant == "focus_ema")
    assert pm.step == int(new_state.step) == 1
    assert_moved_alike(pm, state, new_state)
    for n in DIS_NAMES:
        assert all(p.grad is not None for p in pm.dis(n).parameters())
    if variant == "no_focus":
        assert pm.ema is None and new_state.ema_params is None
        return
    ema = jax.device_get(new_state.ema_params)
    for n in GEN_NAMES:
        got_ema = map_generator_state_dict(pm.ema[n], pm.cfg.gen)
        assert rel_l2(got_ema, ema[n]) < 1e-6, n
        live = dict(pm.gen(n).named_parameters())
        assert all(t.data_ptr() != live[k].data_ptr() for k, t in pm.ema[n].items())


def test_gradients_of_all_five_networks_match_jax(smooth):
    jm, state, pm = smooth
    (xa, xb), = batches(1, seed=7)
    z = jax_z(jm, 0)["gen"]
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
        assert rel_l2(port_tree(pm, n, "grad"), jax.device_get(d_grads[n])) < 1e-3, n
    for n in GEN_NAMES:
        assert rel_l2(port_tree(pm, n, "grad"), jax.device_get(g_grads[n])) < 1e-3, n


def test_ten_iteration_trajectory_matches_jax(smooth):
    """The shipped D1/G2 cadence over 10 iterations, crossing the StepLR
    boundaries at 4 and 8: losses, learning rates and each network's total
    parameter movement (Adam with coupled L2, the G step on the stepped D)."""
    jm, state0, _ = smooth
    pm = port_model(jm, state0)
    state = state0
    data = batches(10)
    j_loss, p_loss, j_lr, p_lr = [], [], [], []
    for it, (xa, xb) in enumerate(data):
        do_gen = it % 2 == 0
        j_lr.append(float(jm.learning_rate(state.step)))
        p_lr.append(pm.learning_rate(pm.step))
        state, jmet = jm.train_step(state, jnp.asarray(xa), jnp.asarray(xb), BASE_KEY,
                                    True, do_gen)
        pmet = pm.train_step(xa, xb, True, do_gen, z=jax_z(jm, it))
        keys = ["loss_dis_total"] + (["loss_gen_total"] if do_gen else [])
        assert set(pmet) == set(jmet)
        j_loss.append([float(jmet[k]) for k in keys])
        p_loss.append([float(pmet[k]) for k in keys])
    np.testing.assert_allclose(p_lr, j_lr, rtol=1e-6)
    assert p_lr[0] == pytest.approx(1e-4) and p_lr[-1] == pytest.approx(0.25e-4)
    np.testing.assert_allclose(sum(p_loss, []), sum(j_loss, []), rtol=2e-3)
    assert pm.step == int(state.step) == 10
    assert_moved_alike(pm, state0, state)


@pytest.fixture(scope="module")
def smooth_ema():
    """`smooth` with `tpu.ema_decay: 0.999`, the synthfaces_hard setting."""
    return _pair(_config(focus_delta=0.0, focus_epsilon=10.0,
                         tpu=dataclasses.replace(tiny_config().tpu, ema_decay=0.999)))


def _ema_movement(ema, ema0):
    return {n: jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                      ema[n], ema0[n]) for n in GEN_NAMES}


def test_ten_iteration_ema_trajectory_matches_jax(smooth_ema):
    """The D1/G2 cadence over 10 iterations with EMA 0.999 on the JAX z: the
    EMA moves only after a G step, in both packages, and its movement from
    the initial weights matches the JAX `ema_params`' within the movement
    tolerance of the parameters (`aclgan_tpu/trainer.py:598-602`)."""
    jm, state0, _ = smooth_ema
    pm = port_model(jm, state0)
    state = state0

    def port_ema():
        return {n: map_generator_state_dict({k: t.clone() for k, t in pm.ema[n].items()},
                                            pm.cfg.gen) for n in GEN_NAMES}

    ema0 = port_ema()
    for it, (xa, xb) in enumerate(batches(10)):
        do_gen = it % 2 == 0
        before_p, before_j = port_ema(), jax.device_get(state.ema_params)
        state, _ = jm.train_step(state, jnp.asarray(xa), jnp.asarray(xb), BASE_KEY, True,
                                 do_gen)
        pm.train_step(xa, xb, True, do_gen, z=jax_z(jm, it))
        after_p, after_j = port_ema(), jax.device_get(state.ema_params)
        for n in GEN_NAMES:
            moved_p = rel_l2(after_p[n], before_p[n]) > 0
            moved_j = rel_l2(after_j[n], before_j[n]) > 0
            assert moved_p == moved_j == do_gen, (it, n, moved_p, moved_j)
    got = _ema_movement(port_ema(), ema0)
    want = _ema_movement(jax.device_get(state.ema_params), jax.device_get(state0.ema_params))
    for n in GEN_NAMES:
        assert rel_l2(got[n], want[n]) < MOVE_TOL["gen"], n
    # ten iterations at 0.999: the EMA holds a hundredth of the weights' way
    live = _ema_movement(port_tree_gens(pm), ema0)
    ratio = np.linalg.norm(flat(got)) / np.linalg.norm(flat(live))
    assert 0.002 < ratio < 0.01, ratio


def port_tree_gens(pm):
    return {n: port_tree(pm, n) for n in GEN_NAMES}


def test_step_increment_and_own_noise():
    """Skipped iterations advance the step (and the lr); without z the port
    draws its own, reproducibly from the seed; metrics come back detached."""
    cfg = from_dict(_config(step_size=2).to_dict())
    runs = []
    for _ in range(2):
        pm = ACLGAN(cfg, device="cpu", seed=3)
        pm.init_state()
        xa, xb = batches(1)[0]
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
    xa, xb = batches(1)[0]
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
    xa, xb = batches(1, seed=8)[0]
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
    (dict(grad_accum=3), "grad_accum"),
    (dict(remat="bogus"), "remat"),
    (dict(moment_dtype="float16"), "moment_dtype"),
])
def test_unported_train_options_raise(tpu_change, match):
    """The train options are ported (tests/test_torch_train_options.py); what
    still raises is a value they cannot take: a batch of 2 that grad_accum 3
    does not divide, an unknown remat family, a moment dtype other than
    float32 or bfloat16."""
    cfg = from_dict(tiny_config().to_dict())
    cfg.tpu = dataclasses.replace(cfg.tpu, **tpu_change)
    with pytest.raises(ValueError, match=match):
        pm = ACLGAN(cfg, device="cpu")
        pm.init_state()
        pm.train_step(*batches(1)[0], True, True)
