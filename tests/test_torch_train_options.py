"""The port's training options against the JAX package: `tpu.remat` (every
family), `tpu.grad_accum` (the strided micro-split) and `tpu.moment_dtype:
bfloat16` (`aclgan_tpu_torch.optim.Adam` with bf16 first moments against optax). The same
weights, batches and z go to both, on the CPU in float32."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from aclgan_tpu.trainer import ACLGAN as JACLGAN
from aclgan_tpu.trainer import to_model_range as jto_model_range
from aclgan_tpu_torch import trainer as port_trainer
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.optim import Adam
from aclgan_tpu_torch.trainer import ACLGAN, GEN_NAMES
from tests.helpers import tiny_config
from tests.torch_parity import (BASE_KEY, assert_metrics, assert_moved_alike, batches,
                                jax_z, port_model, port_tree, rel_l2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth(**tpu):
    """focus_delta 0, focus_epsilon 10: well-conditioned focus gradients
    (tests/test_reference_parity.py:487-496), plus `tpu` changes."""
    cfg = tiny_config(alpha=0.7, weight_decay=1e-4, focus_delta=0.0, focus_epsilon=10.0)
    cfg.tpu = dataclasses.replace(cfg.tpu, **tpu)
    return cfg


def _with(pm, **tpu):
    """A port model like `pm` with `tpu` changes, on pm's weights."""
    cfg = dataclasses.replace(pm.cfg, tpu=dataclasses.replace(pm.cfg.tpu, **tpu))
    other = ACLGAN(cfg, device="cpu")
    for n in GEN_NAMES:
        other.gen(n).load_state_dict(pm.gen(n).state_dict())
    other.init_state()
    for n in ("A", "B", "2"):
        other.dis(n).load_state_dict(pm.dis(n).state_dict())
    return other


@pytest.fixture(scope="module")
def gen_grads():
    """JAX's generator loss and gradients at the initial weights (no remat),
    with the port model on the same weights and the inputs."""
    jm = JACLGAN(_smooth())
    state = jm.init_state(jax.random.PRNGKey(0), (16, 16))
    (xa, xb), = batches(1, seed=7)
    z = jax_z(jm, 0)["gen"]
    ja, jb = (jto_model_range(jnp.asarray(v)) for v in (xa, xb))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jm._gen_loss_fn(
        p, state.dis_params, state.dis_spectral, state.dis_stats, ja, jb,
        *(jnp.asarray(v) for v in z))[0]))(state.gen_params)
    return port_model(jm, state), (xa, xb, z), float(loss), jax.device_get(grads)


def _port_loss_grads(pm, xa, xb, z):
    total, _ = pm._gen_loss(pm._images(xa), pm._images(xb),
                            tuple(torch.from_numpy(v) for v in z))
    grads = torch.autograd.grad(total, pm.gen_params)
    for p, g in zip(pm.gen_params, grads):
        p.grad = g
    return float(total), torch.cat([g.flatten() for g in grads]).numpy()


@pytest.mark.parametrize("remat,calls", [(True, 7), ("all", 7), ("encode", 5),
                                         ("decode", 2)])
def test_remat_family_matches_no_remat_and_jax(gen_grads, monkeypatch, remat, calls):
    """The generator loss and gradients under each family equal the port's
    without remat (tests/test_trainer.py:193-197's tolerances) and JAX's;
    `checkpoint` wraps the family's calls of the G step (3 content + 2 style
    encodes, 2 decodes) and none of the D step's."""
    pm0, (xa, xb, z), jloss, jgrads = gen_grads
    wrapped = []

    def counting(fn, *args, **kw):
        wrapped.append(fn.__name__)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(port_trainer, "checkpoint", counting)
    pm = _with(pm0, remat=remat)
    l0, g0 = _port_loss_grads(pm0, xa, xb, z)
    l1, g1 = _port_loss_grads(pm, xa, xb, z)
    assert len(wrapped) == calls
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(g1, g0, rtol=1e-3, atol=2.5e-4)
    np.testing.assert_allclose(l1, jloss, rtol=1e-5)
    for n in GEN_NAMES:
        assert rel_l2(port_tree(pm, n, "grad"), jgrads[n]) < 1e-3, n
    wrapped.clear()
    pm.train_step(xa, xb, True, False, z={"dis": z})
    assert wrapped == []


def test_remat_rejects_unknown_value():
    cfg = from_dict(tiny_config().to_dict())
    cfg.tpu = dataclasses.replace(cfg.tpu, remat="bogus")
    with pytest.raises(ValueError, match="tpu.remat must be"):
        ACLGAN(cfg, device="cpu")


def test_grad_accum_matches_jax():
    """grad_accum 2 over a batch of 4, one D+G iteration: the metrics (the
    micro-batch means), each network's movement, and the generators'
    gradients against JAX's mean of the two strided micro-batches' gradients
    taken against the stepped discriminators."""
    jm = JACLGAN(_smooth(grad_accum=2))
    state0 = jm.init_state(jax.random.PRNGKey(1), (16, 16))
    pm = port_model(jm, state0)
    (xa, xb), = batches(1, batch=4, seed=9)
    z = jax_z(jm, 0, batch=4)
    state1, want = jm.train_step(state0, jnp.asarray(xa), jnp.asarray(xb), BASE_KEY,
                                 True, True)
    got = pm.train_step(xa, xb, True, True, z=z)
    assert_metrics(got, want)
    assert_moved_alike(pm, state0, state1)
    ja, jb = (jto_model_range(jnp.asarray(v)) for v in (xa, xb))
    jz = [jnp.asarray(v) for v in z["gen"]]
    grad_fn = jax.jit(jax.grad(lambda p, a, b, z1, z2, z3: jm._gen_loss_fn(
        p, state1.dis_params, state1.dis_spectral, state1.dis_stats, a, b, z1, z2, z3)[0]))
    micro = [grad_fn(state0.gen_params, ja[m::2], jb[m::2], *(v[m::2] for v in jz))
             for m in range(2)]
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *micro)
    for n in GEN_NAMES:
        assert rel_l2(port_tree(pm, n, "grad"), jax.device_get(mean[n])) < 1e-3, n


def test_grad_accum_rejects_indivisible_batch():
    cfg = from_dict(tiny_config().to_dict())
    cfg.tpu = dataclasses.replace(cfg.tpu, grad_accum=3)
    pm = ACLGAN(cfg, device="cpu")
    pm.init_state()
    xa, xb = batches(1, batch=4)[0]
    with pytest.raises(ValueError, match="batch_size 4 not divisible by tpu.grad_accum 3"):
        pm.train_step(xa, xb, True, True)


def _bits(t):
    return np.asarray(t).view(np.uint16)


@pytest.mark.parametrize("wd,b1", [(1e-4, 0.5), (0.0, 0.9)])
def test_bf16_adam_matches_optax(wd, b1):
    """Five updates on the same random gradients: optax's
    chain(add_decayed_weights, scale_by_adam(mu_dtype=bfloat16)) (bare
    scale_by_adam at wd 0) and `Adam(mu_dtype=bfloat16)` keep a bit-equal bf16 mu, nu
    within 1e-6 relative and the params within 1e-6."""
    rng = np.random.RandomState(0)
    shapes = [(8, 4, 3, 3), (16,), (5, 7)]
    params0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    adam = optax.scale_by_adam(b1=b1, b2=0.999, eps=1e-8, mu_dtype=jnp.bfloat16)
    tx = optax.chain(optax.add_decayed_weights(wd), adam) if wd > 0 else adam
    jparams = [jnp.asarray(p) for p in params0]
    jstate = tx.init(jparams)
    tparams = [torch.tensor(p, requires_grad=True) for p in params0]
    opt = Adam(tparams, lr=1e-3, betas=(b1, 0.999), eps=1e-8, weight_decay=wd,
               mu_dtype=torch.bfloat16)
    for step in range(5):
        lr = 1e-3 * 0.5 ** (step // 2)
        grads = [rng.randn(*s).astype(np.float32) * 10.0 ** rng.randint(-6, 1)
                 for s in shapes]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, jax.tree_util.tree_map(lambda u: -lr * u, upd))
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.param_groups[0]["lr"] = lr
        opt.step()
        adam_state = jstate[1] if wd > 0 else jstate
        for i, p in enumerate(tparams):
            st = opt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16 and int(st["step"]) == step + 1
            assert adam_state.mu[i].dtype == jnp.bfloat16
            np.testing.assert_array_equal(_bits(st["exp_avg"].view(torch.int16).numpy()),
                                          _bits(adam_state.mu[i]))
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), adam_state.nu[i],
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(p.detach().numpy(), jparams[i], rtol=0, atol=1e-6)
    sd = opt.state_dict()
    assert set(sd["state"][0]) == {"step", "exp_avg", "exp_avg_sq"}
    again = Adam([torch.zeros_like(p) for p in tparams], lr=1e-3, mu_dtype=torch.bfloat16)
    again.load_state_dict(sd)
    assert all(st["exp_avg"].dtype == torch.bfloat16 for st in again.state.values())


def test_bf16_moments_full_step_matches_jax():
    """moment_dtype bfloat16: one D+G iteration and one D iteration against
    JAX's (metrics, each network's movement); both Adams store bf16 first
    moments."""
    jm = JACLGAN(_smooth(moment_dtype="bfloat16"))
    state0 = jm.init_state(jax.random.PRNGKey(2), (16, 16))
    pm = port_model(jm, state0)
    assert all(isinstance(o, Adam) and o.mu_dtype == torch.bfloat16
               for o in (pm.gen_opt, pm.dis_opt))
    state = state0
    for it, ((xa, xb), do_gen) in enumerate(zip(batches(2, seed=11), (True, False))):
        state, want = jm.train_step(state, jnp.asarray(xa), jnp.asarray(xb), BASE_KEY,
                                    True, do_gen)
        assert_metrics(pm.train_step(xa, xb, True, do_gen, z=jax_z(jm, it)), want)
    assert_moved_alike(pm, state0, state)
    for opt in (pm.gen_opt, pm.dis_opt):
        assert all(st["exp_avg"].dtype == torch.bfloat16 for st in opt.state.values())
