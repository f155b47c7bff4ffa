"""Port snapshots (`aclgan_tpu_torch.utils.checkpoint`): a bit-exact round
trip, resume that continues a run bitwise (z stream included), the snapshot
set's consistency checks, keep-N, and the `.pt` layout read by the JAX
package's `aclgan_tpu.utils.torch_import`."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclgan_tpu.trainer import ACLGAN as JACLGAN
from aclgan_tpu.utils.torch_import import (import_torch_dis_checkpoint,
                                           import_torch_gen_checkpoint)
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils import checkpoint as ckpt
from tests.helpers import tiny_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the test workers share the
    cores (eight threads a worker oversubscribe them many times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(ema=0.99):
    jcfg = tiny_config(weight_decay=1e-4)
    jcfg.tpu = dataclasses.replace(jcfg.tpu, ema_decay=ema)
    return from_dict(jcfg.to_dict())


def _model(cfg, seed=0):
    m = ACLGAN(cfg, device="cpu", seed=seed)
    m.init_state()
    return m


def _batch(i):
    rng = np.random.RandomState(100 + i)
    return tuple(rng.randint(0, 256, (2, 16, 16, 3), dtype=np.uint8) for _ in range(2))


def _run(model, iters):
    for i in iters:
        model.train_step(*_batch(i), True, i % 2 == 0)


def _flat(obj, prefix=""):
    """Every leaf of a snapshot, by path."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(obj, (list, tuple)):
        return _flat(dict(enumerate(obj)), prefix)
    return {prefix: obj}


def _assert_bitwise(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu()), k
        else:
            assert g == w, k


def test_round_trip_is_bit_exact(tmp_path):
    cfg = _cfg()
    m = _model(cfg)
    _run(m, range(3))
    ckpt.save_checkpoint(str(tmp_path), m, iterations=2)
    assert sorted(os.listdir(tmp_path)) == ["dis_00000003.pt", "ema_00000003.pt",
                                            "gen_00000003.pt", "optimizer.pt"]
    opt = torch.load(tmp_path / "optimizer.pt", weights_only=True)
    assert set(opt) == {"gen", "dis", "step", "saved_iteration", "rng"}
    assert opt["saved_iteration"] == 3 and opt["step"] == 3
    dis = torch.load(tmp_path / "dis_00000003.pt", weights_only=True)
    assert set(dis) == {"A", "B", "2"} and "cnns.0.0.conv.weight" in dis["A"]
    fresh = _model(cfg, seed=9)
    assert ckpt.load_checkpoint(str(tmp_path), fresh) == 3
    _assert_bitwise(fresh.snapshot(), m.snapshot())


def test_resume_continues_the_run_bitwise(tmp_path):
    """Four steps straight equal two, a snapshot, a fresh model resumed from
    it, and two more: weights, EMA, both Adams, the step and the z stream."""
    cfg = _cfg()
    straight = _model(cfg)
    _run(straight, range(4))
    first = _model(cfg)
    _run(first, range(2))
    ckpt.save_checkpoint(str(tmp_path), first, iterations=1)
    resumed = _model(cfg, seed=7)  # other weights and z stream until restored
    assert ckpt.resume(str(tmp_path), resumed) == 2
    _run(resumed, range(2, 4))
    _assert_bitwise(resumed.snapshot(), straight.snapshot())


@pytest.fixture()
def saved(tmp_path):
    """Snapshot sets at iterations 2 and 4 of one run."""
    cfg = _cfg()
    m = _model(cfg)
    _run(m, range(2))
    ckpt.save_checkpoint(str(tmp_path), m, iterations=1)
    _run(m, range(2, 4))
    ckpt.save_checkpoint(str(tmp_path), m, iterations=3)
    return cfg, m, tmp_path


@pytest.mark.parametrize("tear,match", [
    (lambda d: [os.remove(d / f) for f in os.listdir(d) if f.startswith("dis_")],
     "no dis checkpoint"),
    (lambda d: os.remove(d / "dis_00000004.pt"), "newest dis is iteration 2"),
    (lambda d: os.remove(d / "gen_00000002.pt") or os.replace(
        d / "gen_00000004.pt", d / "gen_00000006.pt")
     or os.replace(d / "dis_00000004.pt", d / "dis_00000006.pt"),
     "optimizer.pt was written at iteration 4"),
    (lambda d: os.remove(d / "optimizer.pt"), "optimizer.pt does not"),
])
def test_torn_snapshot_sets_are_refused(saved, tear, match):
    cfg, _, d = saved
    tear(d)
    with pytest.raises(RuntimeError, match=match):
        ckpt.load_checkpoint(str(d), _model(cfg))
    assert ckpt.get_model_list(str(d / "missing"), "gen") is None


def test_no_gen_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path), _model(_cfg()))


def test_imported_weights_start_fresh_moments_and_seed_the_ema(saved):
    """With `imported.marker` and no optimizer file: the weights load, the
    moments are fresh, the step comes from the file name; without an ema
    file, the EMA starts from a copy of the loaded generator weights."""
    cfg, m, d = saved
    os.remove(d / "optimizer.pt")
    os.remove(d / "ema_00000004.pt")
    (d / "imported.marker").touch()
    fresh = _model(cfg, seed=3)
    assert ckpt.load_checkpoint(str(d), fresh) == 4
    assert fresh.step == 4 and fresh.gen_opt.state_dict()["state"] == {}
    for n in ("AB", "BA"):
        live = dict(fresh.gen(n).named_parameters())
        for k, want in m.gen(n).state_dict().items():
            assert torch.equal(live[k], want)
            assert torch.equal(fresh.ema[n][k], want)
            assert fresh.ema[n][k].data_ptr() != live[k].data_ptr()


def test_keep_prunes_gen_dis_and_ema(tmp_path):
    m = _model(_cfg())
    for it in range(4):
        ckpt.save_checkpoint(str(tmp_path), m, iterations=it, keep=2)
    files = sorted(os.listdir(tmp_path))
    assert files == ["dis_00000003.pt", "dis_00000004.pt", "ema_00000003.pt",
                     "ema_00000004.pt", "gen_00000003.pt", "gen_00000004.pt",
                     "optimizer.pt"]
    assert ckpt.get_model_list(str(tmp_path), "gen").endswith("gen_00000004.pt")
    assert ckpt.parse_iteration(ckpt.get_model_list(str(tmp_path), "ema")) == 4


def test_jax_torch_import_reads_port_snapshots(tmp_path):
    """`import_torch_gen_checkpoint` / `import_torch_dis_checkpoint` read a port
    snapshot; the JAX networks on those weights give the port's outputs."""
    jcfg = tiny_config()
    cfg = from_dict(jcfg.to_dict())
    m = _model(cfg, seed=4)
    _run(m, range(2))
    ckpt.save_checkpoint(str(tmp_path), m, iterations=1)
    jm = JACLGAN(jcfg)
    template = jm.init_state(jax.random.PRNGKey(0), (16, 16))
    gen = import_torch_gen_checkpoint(str(tmp_path / "gen_00000002.pt"),
                                      template.gen_params, jcfg.gen)
    dis = import_torch_dis_checkpoint(str(tmp_path / "dis_00000002.pt"),
                                      template.dis_params, jcfg.dis)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    pair = rng.uniform(-1, 1, (2, 16, 16, 6)).astype(np.float32)
    z = rng.randn(2, jcfg.gen.style_dim).astype(np.float32)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    tol = dict(rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        for n in ("AB", "BA"):
            content, style = jm.gen_encode(gen[n], jnp.asarray(x))
            want = jm.gen_decode(gen[n], content, jnp.asarray(z))
            c_t, s_t = m.gen(n).encode(nchw(x))
            got = m.gen(n).decode(c_t, torch.from_numpy(z))
            np.testing.assert_allclose(s_t.numpy(), np.asarray(style), **tol)
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                       **tol)
        for n, inp in (("A", x), ("B", x), ("2", pair)):
            want, _, _ = jm.dis_apply(dis[n], template.dis_spectral[n], jnp.asarray(inp))
            got = m.dis(n)(nchw(inp))
            assert len(got) == len(want) == jcfg.dis.num_scales
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                           **tol)
