"""The port's data parallelism (`aclgan_tpu_torch/parallel/mesh.py`, the
trainer under a mesh) against the single-process port step and the JAX
single-device step: two gloo ranks on the CPU, spawned once, run one D+G
iteration at global batch 8 on their rows (dis none, dis bn, and dis bn
under grad_accum 2), on the same weights and z. Also each rank's loader rows
against the JAX loader's, and the mesh's errors."""

import copy
import dataclasses
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from aclgan_tpu.data import loader as jloader
from aclgan_tpu.trainer import ACLGAN as JACLGAN
from aclgan_tpu_torch.cli import train as cli_train
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.parallel import mesh as pmesh
from aclgan_tpu_torch.parallel import spatial as psp
from aclgan_tpu_torch.trainer import ACLGAN, DIS_NAMES, GEN_NAMES
from tests import torch_dp_worker
from tests.helpers import tiny_config
from tests.torch_parity import (BASE_KEY, assert_collections, assert_metrics,
                                assert_moved_alike, batches, jax_z, port_model)

WORLD, BATCH = 2, 8
CASES = {"dis_none": dict(norm="none"), "dis_bn": dict(norm="bn"),
         "dis_bn_accum2": dict(norm="bn", grad_accum=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(case):
    spec = CASES[case]
    cfg = tiny_config(batch_size=BATCH, weight_decay=1e-4)
    cfg.dis.norm = spec["norm"]
    cfg.tpu.grad_accum = spec.get("grad_accum", 1)
    cfg.gen.dim, cfg.gen.mlp_dim, cfg.gen.n_res, cfg.dis.dim = 4, 8, 1, 4
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the JAX step, the single-process port step and both ranks'
    results of the data-parallel port step, from one JAX initial state."""
    tmp = tmp_path_factory.mktemp("dp")
    (xa, xb), = batches(1, batch=BATCH, seed=31)
    out, cases = {}, []
    for case in CASES:
        jm = JACLGAN(_jax_cfg(case))
        state0 = jm.init_state(jax.random.PRNGKey(0), (16, 16))
        z = jax_z(jm, 0, batch=BATCH)
        pm = port_model(jm, state0)
        snap_path = tmp / f"{case}.snap.pt"
        torch.save(copy.deepcopy(pm.snapshot()), snap_path)
        state1, jax_metrics = jm.train_step(state0, jnp.asarray(xa), jnp.asarray(xb),
                                            BASE_KEY, True, True)
        single = pm.train_step(xa, xb, True, True, z=z)
        out[case] = dict(jm=jm, state0=state0, state1=state1, jax_metrics=jax_metrics,
                         single=single, single_model=pm)
        cases.append((case, pm.cfg.to_dict(), str(snap_path), torch.from_numpy(xa),
                      torch.from_numpy(xb), z))
    torch_dp_worker.spawn(torch_dp_worker.dp_steps, WORLD, (cases, str(tmp)), timeout=240)
    for case in CASES:
        out[case]["ranks"] = [torch.load(tmp / f"{case}.{r}.pt", weights_only=True)
                              for r in range(WORLD)]
    return out


def _model_from(run, ranks_result):
    """A port model holding one rank's networks after the step."""
    pm = ACLGAN(from_dict(run["single_model"].cfg.to_dict()), device="cpu")
    pm.init_state()
    for n in GEN_NAMES:
        pm.gen(n).load_state_dict(ranks_result["gen"][n])
    for n in DIS_NAMES:
        pm.dis(n).load_state_dict(ranks_result["dis"][n])
    return pm


def _flat(state_dicts):
    return torch.cat([v.double().flatten() for sd in state_dicts.values()
                      for v in sd.values()])


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_step_matches_single_process_step(runs, case):
    """Metrics rel 1e-5, each network's params rel-L2 1e-4, and the ranks
    hold equal state after the step."""
    run = runs[case]
    r0, r1 = run["ranks"]
    single = run["single"]
    assert set(r0["metrics"]) == set(single)
    for k, v in single.items():
        np.testing.assert_allclose(float(r0["metrics"][k]), float(v), rtol=1e-5, err_msg=k)
        assert float(r1["metrics"][k]) == float(r0["metrics"][k]), k
    snap = run["single_model"].snapshot()
    for kind, names in (("gen", GEN_NAMES), ("dis", DIS_NAMES)):
        for n in names:
            want = _flat({n: snap[kind][n]})
            got = _flat({n: r0[kind][n]})
            assert float((got - want).norm() / want.norm()) < 1e-4, (kind, n)
            for k, t in r0[kind][n].items():
                assert torch.equal(t, r1[kind][n][k]), (kind, n, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_step_matches_jax_single_device_step(runs, case):
    """Rank 0's step against the JAX step at the global batch, with the
    tolerances of the port's single-process parity tests."""
    run = runs[case]
    assert_metrics(run["ranks"][0]["metrics"], run["jax_metrics"])
    pm = _model_from(run, run["ranks"][0])
    # bn's running_mean: the conv bias in front of it has a float-noise
    # gradient, so Adam's D step moves it by +-lr with a sign that differs
    # between frameworks, and each of the G step's grad_accum micro-batch
    # forwards carries a tenth of that into the running mean
    atol = 0.3 * pm.cfg.lr * pm.accum if pm.cfg.dis.norm == "bn" else 1e-6
    assert assert_collections(pm, run["state1"], atol=atol) == (
        12 if pm.cfg.dis.norm == "bn" else 0)
    assert_moved_alike(pm, run["state0"], run["state1"])


@pytest.mark.parametrize("rank", range(WORLD))
def test_rank_loaders_match_jax(tmp_path, rank):
    """A rank's four loaders (`cli.train.rank_loaders`): batch B / world and
    seed `seed + rank`, as the JAX CLI builds them for process `rank`."""
    jcfg = tiny_config(batch_size=4, seed=7)
    mesh = pmesh.DataMesh(rank=rank, world=WORLD)
    got = cli_train.rank_loaders(from_dict(jcfg.to_dict()), mesh)
    want = jloader.get_all_data_loaders(dataclasses.replace(jcfg, batch_size=2),
                                        seed=jcfg.seed + rank)
    for g, w in zip(got, want):
        assert g.batch_size == w.batch_size == 2
        for gb, wb in zip(list(g), list(w), strict=True):
            assert gb.dtype == wb.dtype and np.array_equal(gb, wb)


def test_rank_loaders_refuse_an_indivisible_batch():
    cfg = from_dict(tiny_config(batch_size=3).to_dict())
    with pytest.raises(SystemExit, match="batch_size 3 not divisible by 2 processes"):
        cli_train.rank_loaders(cfg, pmesh.DataMesh(rank=0, world=2))


def test_single_process_mesh_errors(monkeypatch):
    """Without a process group, mesh_data > 1 raises naming torchrun; -1 and
    1 give no mesh; `tpu.distributed` without torchrun's environment raises."""
    assert not dist.is_initialized()
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT unset"):
        pmesh.init_distributed("cpu")
    for n in (-1, 1):
        assert pmesh.make_mesh(n) is None
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node N .*tpu.distributed"):
        pmesh.make_mesh(2)
    assert pmesh.batch_sharding(None, 6) == slice(0, 6)
    with pytest.raises(ValueError, match="not divisible by 4 processes"):
        pmesh.batch_sharding(pmesh.DataMesh(rank=1, world=4), 6)
    assert pmesh.batch_sharding(pmesh.DataMesh(rank=1, world=2), 6) == slice(3, 6)


def test_group_mesh_errors():
    """In a group of one process: mesh_data larger than the world raises the
    JAX message; -1 and 1 give a mesh of one rank."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{torch_dp_worker.free_port()}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="mesh_data=2 > available devices 1"):
            pmesh.make_mesh(2)
        assert pmesh.make_mesh(-1) == pmesh.make_mesh(1) == pmesh.DataMesh(0, 1)
    finally:
        dist.destroy_process_group()


def test_gloo_meshes_are_not_captured():
    """A mesh answers `capturable()` from its groups' backend: no for gloo,
    and without a process group; a model on a CUDA device under a gloo mesh
    keeps its steps eager and names the reason."""
    grid = psp.SpatialMesh(1, 1, 0, None, None, None)
    assert not pmesh.DataMesh(0, 1).capturable() and not grid.capturable()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{torch_dp_worker.free_port()}",
                            rank=0, world_size=1)
    try:
        for mesh in (pmesh.make_mesh(-1), grid):
            assert not mesh.capturable()
            model = ACLGAN(from_dict(_jax_cfg("dis_none").to_dict()), device="cpu", mesh=mesh)
            model.device = torch.device("cuda")  # the question asked before any CUDA work
            assert model._eager_reason(True) == (f"a {type(mesh).__name__} over gloo: its "
                                                 "collectives are staged through the host")
    finally:
        dist.destroy_process_group()


# The deadline of the hung-rank spawn. Both ranks must import torch, join
# gloo and start their second all-reduce well before the dump at the deadline
# less `dump_margin`: on a host loaded by six test workers a 10 s deadline
# left no room (both ranks were still importing when it passed and were
# killed without a stack).
HUNG_DEADLINE = 40.0


def test_spawn_kills_a_hung_rank_at_its_deadline(tmp_path):
    """A rank that sleeps past the spawn's one deadline: `spawn` raises within
    the deadline and a small margin, with the sleeping rank's Python stack
    and both ranks' collective logs (the flight recorder) in its message; the
    waiting rank's collective ends at its group's timeout first."""
    t0 = time.time()
    with pytest.raises(RuntimeError) as raised:
        torch_dp_worker.spawn(torch_dp_worker.hang_one_rank, 2, (600,),
                              timeout=HUNG_DEADLINE, dump_dir=tmp_path)
    took = time.time() - t0
    msg = str(raised.value)
    assert took < HUNG_DEADLINE + 5, took
    assert "rank 1: stack" in msg and "_sleep_past_the_deadline" in msg
    assert "rank 0: traceback" in msg
    for rank in (0, 1):
        assert f"rank {rank}: collective log" in msg
    assert "all_reduce" in msg.split("rank 1: collective log")[1]


def test_spawn_removes_its_own_dump_directory_after_a_clean_run(tmp_path, monkeypatch):
    """A spawn given no dump directory makes a temporary one and removes it
    once every rank has ended cleanly."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    torch_dp_worker.spawn(torch_dp_worker.hang_one_rank, 2, (0,), timeout=120)
    assert list(tmp_path.iterdir()) == []


class _NcclMesh(pmesh.DataMesh):
    def capturable(self):  # NCCL's answer, without NCCL on the CPU
        return True


class _NcclGrid(psp.SpatialMesh):
    def capturable(self):
        return True


@pytest.mark.parametrize("world", [1, 2, 4])
def test_an_nccl_mesh_of_one_rank_is_captured(world):
    """On a CUDA device, a capturable (NCCL) data-parallel mesh and a
    capturable spatial grid of any size give no eager reason; the same grid
    over gloo, and `tpu.check_nans`, keep the steps eager and name why."""
    model = ACLGAN(from_dict(_jax_cfg("dis_none").to_dict()), device="cpu")
    model.device = torch.device("cuda")  # the question asked before any CUDA work
    model.mesh = _NcclMesh(0, world)
    assert model._eager_reason(True) is None
    model.mesh = _NcclGrid(1, world, 0, None, None, None)
    assert model._eager_reason(True) is None
    model.mesh = psp.SpatialMesh(1, world, 0, None, None, None)  # not initialized: not NCCL
    assert model._eager_reason(True) == ("a SpatialMesh over gloo: its collectives are "
                                         "staged through the host")
    model.mesh = _NcclGrid(1, world, 0, None, None, None)
    model.cfg = dataclasses.replace(model.cfg, tpu=dataclasses.replace(model.cfg.tpu,
                                                                        check_nans=True))
    assert model._eager_reason(True) == "tpu.check_nans: anomaly mode cannot be captured"