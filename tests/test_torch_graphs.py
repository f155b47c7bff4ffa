"""The port's compiled step on the CPU (`aclgan_tpu_torch.graphs`,
`aclgan_tpu_torch.optim.Adam`): what lets the card capture the train step.

- The step body reads no tensor back to the host: `train_step` runs under a
  dispatch mode that raises on `aten._local_scalar_dense` (what `.item()`,
  `int()`, `float()` and `bool()` of a tensor reach; on the card `.tolist()`
  too).
- The capture-ready Adam, float32 and bfloat16 first moments, against optax
  built as the JAX package builds it (`aclgan_tpu/trainer.py:100-109`), with
  the JAX package's StepLR schedule (`:140-147`), over 12 updates with
  `step_increment` 2 across StepLR boundaries.
- `StepGraphs`' launch bookkeeping with a stand-in graph object: a capture's
  counter increments are taken back, each replay adds the recorded change.
- Under a data-parallel mesh (two gloo ranks, spawned once): the step body
  holds every collective of the step, the metrics' all-reduce too, and
  reads nothing to the host; the step and `sample` through `StepGraphs`
  with a stand-in graph that records the ops of a capture and replays them
  (`tests/torch_dp_worker.py::ReplayGraph`) equal the eager forms bit for
  bit, K1 counted per replay as per eager call; keys that differ across the
  ranks, and a capture that fails on one rank, raise on every rank.
- The optimizer's `.pt` and `.msgpack` layouts, and a state written by
  `torch.optim.Adam` (the float32 path before this optimizer) loaded.
- `chip_smoke._hold_trace`, which holds a replay's kernel events in a
  profiler trace to the launches the graph recorded.

The graphed step on the card against the eager one is in
`tests/test_torch_cuda.py`.
"""

import contextlib
import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp
import optax

import chip_smoke
import torch.distributed as dist

from aclgan_tpu.trainer import ACLGAN as JACLGAN
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.graphs import StepGraphs
from aclgan_tpu_torch.ops.kernels import instance_norm as K
from aclgan_tpu_torch.optim import Adam
from aclgan_tpu_torch.parallel import mesh as pmesh
from aclgan_tpu_torch.trainer import ACLGAN, DIS_NAMES, GEN_NAMES
from aclgan_tpu_torch.utils import checkpoint as ckpt
from tests import torch_dp_worker
from tests.helpers import tiny_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("the step read a tensor back to the host")
        return func(*args, **(kwargs or {}))


def _model(mesh=None, dis_norm="none", **tpu):
    jcfg = tiny_config(weight_decay=1e-4)
    jcfg.dis.norm = dis_norm
    jcfg.tpu = dataclasses.replace(jcfg.tpu, **tpu)
    m = ACLGAN(from_dict(jcfg.to_dict()), device="cpu", seed=4, mesh=mesh)
    m.init_state()
    return m


def _batch(i):
    rng = np.random.RandomState(300 + i)
    return tuple(rng.randint(0, 256, (2, 16, 16, 3), dtype=np.uint8) for _ in range(2))


def test_dispatch_mode_sees_host_reads():
    t = torch.ones(2)
    for read in (lambda: t.sum().item(), lambda: float(t[0]), lambda: bool(t[0]),
                 lambda: int(t[1])):
        with pytest.raises(AssertionError, match="host"), _NoHostRead():
            read()


@pytest.fixture
def gloo_mesh():
    """A data-parallel mesh of one gloo rank, this process."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{torch_dp_worker.free_port()}",
                            rank=0, world_size=1)
    try:
        yield pmesh.make_mesh(-1)
    finally:
        dist.destroy_process_group()


class _Collectives:
    """Counts `dist.all_reduce` calls issued inside `ACLGAN._step` and
    outside it, and keeps the last one's tensor."""

    def __init__(self, model, monkeypatch):
        self.inside = self.outside = 0
        self.last = None
        self._in_step = False
        step, all_reduce = model._step, dist.all_reduce

        def in_step(*args, **kwargs):
            self._in_step = True
            try:
                return step(*args, **kwargs)
            finally:
                self._in_step = False

        def counted(t, *args, **kwargs):
            if self._in_step:
                self.inside += 1
            else:
                self.outside += 1
            self.last = t
            return all_reduce(t, *args, **kwargs)

        monkeypatch.setattr(model, "_step", in_step)
        monkeypatch.setattr(dist, "all_reduce", counted)


@pytest.mark.parametrize("case,tpu", [
    ("plain", {}),
    ("remat all, accum 2", {"remat": "all", "grad_accum": 2}),
    ("bf16 moments, EMA", {"moment_dtype": "bfloat16", "ema_decay": 0.999}),
    ("gloo DataMesh, dis bn", {"distributed": True}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_step_body_makes_no_host_sync(case, tpu, request, monkeypatch):
    """D+G, D-only, then D+G across a StepLR boundary with step_increment 2,
    first calls included (they create the optimizers' state): every metric
    finite afterwards. Under a data-parallel mesh (one gloo rank, dis bn:
    the gradients', bn's, the focus sums' and the metrics' all-reduces),
    every collective of `train_step` is issued inside the step body that a
    graph records, the metrics' last."""
    mesh = request.getfixturevalue("gloo_mesh") if tpu.get("distributed") else None
    model = _model(mesh, "none" if mesh is None else "bn", **tpu)
    model.cfg.step_size = 2
    if mesh is not None:
        seen = _Collectives(model, monkeypatch)
    got = []
    with _NoHostRead():
        for i, (do_gen, inc) in enumerate(((True, 1), (False, 1), (True, 2))):
            got.append(model.train_step(*_batch(i), True, do_gen, inc))
    assert model.step == 4
    assert all(np.isfinite(float(v)) for m in got for v in m.values())
    assert "loss_gen_total" in got[0] and "loss_gen_total" not in got[1]
    if mesh is not None:
        assert seen.outside == 0 and seen.inside > 0
        assert seen.last.shape == (len(got[0]),)  # the metrics, stacked


def _jax_lr(jcfg, step):
    """The JAX package's schedule, without building its model."""
    return float(JACLGAN.learning_rate(types.SimpleNamespace(cfg=jcfg), jnp.asarray(step)))


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_adam_matches_optax_across_steplr(mu_dtype, wd):
    """12 updates at global steps 1, 3, ..., 23 (step_increment 2) under
    StepLR every 8 steps: moments and parameters against optax within the
    trainer tests' bars (bf16 mu bit-equal, nu rtol 1e-6, params atol 1e-6),
    the lr tensor equal to the JAX schedule's float32 lr at every update,
    and the step count a device float."""
    jcfg = tiny_config(lr=1e-3, lr_policy="step", step_size=8, gamma=0.5, beta1=0.5)
    pcfg = from_dict(jcfg.to_dict())
    port_lr = types.SimpleNamespace(cfg=pcfg)
    rng = np.random.RandomState(7)
    shapes = [(8, 4, 3, 3), (16,), (5, 7)]
    params0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    adam = optax.scale_by_adam(b1=jcfg.beta1, b2=jcfg.beta2, eps=1e-8,
                               mu_dtype=jnp.dtype(mu_dtype))
    tx = optax.chain(optax.add_decayed_weights(wd), adam) if wd > 0 else adam
    jparams = [jnp.asarray(p) for p in params0]
    jstate = tx.init(jparams)
    tparams = [torch.tensor(p, requires_grad=True) for p in params0]
    opt = Adam(tparams, lr=pcfg.lr, betas=(pcfg.beta1, pcfg.beta2), eps=1e-8,
               weight_decay=wd, mu_dtype=getattr(torch, mu_dtype))
    step, lrs = 0, set()
    for update in range(12):
        step += 1  # step_increment 2: one skipped iteration before each update
        lr_j = _jax_lr(jcfg, step)
        lrs.add(lr_j)
        grads = [rng.randn(*s).astype(np.float32) * 10.0 ** rng.randint(-6, 1)
                 for s in shapes]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(
            jparams, [-jnp.float32(lr_j) * u for u in upd])
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.set_lr(ACLGAN.learning_rate(port_lr, step))
        assert opt._lr[0].item() == np.float32(lr_j)
        opt.update()
        step += 1
        adam_state = jstate[1] if wd > 0 else jstate
        for i, p in enumerate(tparams):
            st = opt.state[p]
            assert st["step"].dtype == torch.float32 and st["step"].item() == update + 1
            if mu_dtype == "bfloat16":
                assert st["exp_avg"].dtype == torch.bfloat16
                np.testing.assert_array_equal(st["exp_avg"].view(torch.int16).numpy(),
                                              np.asarray(adam_state.mu[i]).view(np.int16))
            else:
                np.testing.assert_allclose(st["exp_avg"].numpy(), adam_state.mu[i],
                                           rtol=1e-6, atol=0)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), adam_state.nu[i],
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(p.detach().numpy(), jparams[i], rtol=0, atol=1e-6)
    assert len(lrs) == 3  # two StepLR boundaries crossed (steps 8 and 16)


class _StandInGraph:
    """A CUDA graph's interface on the CPU: records nothing, replays nothing."""

    def __init__(self):
        self.generators, self.pools, self.replays, self.resets = [], [], 0, 0

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.pools.append(pool)

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1

    def reset(self):
        self.resets += 1

    def pool(self):
        return "the pool"


class _CpuGraphs(StepGraphs):
    def __init__(self):
        super().__init__(torch.device("cpu"))
        self.made = []

    def _new_graph(self):
        self.made.append(_StandInGraph())
        return self.made[-1]

    def _on_device(self):
        return contextlib.nullcontext()

    def _side(self):
        return contextlib.nullcontext()

    def _in_order(self):
        return contextlib.nullcontext()

    def _free_cached(self):
        return 0

    def _reserved(self):
        return 0


def _fake_step(x):
    """A body that counts as the kernels' wrappers do: two K1, one K2."""
    K.launches += 2
    K.bwd_launches += 1
    return x * 2, None


def test_launch_counts_under_replay_equal_an_eager_run(monkeypatch):
    for name in K.COUNTERS:
        monkeypatch.setattr(K, name, 0)
    graphs, x = _CpuGraphs(), torch.arange(4.0)
    gen = torch.Generator()
    outs = [graphs.run("k", (x,), _fake_step, (gen,)) for _ in range(4)]
    assert (K.launches, K.bwd_launches) == (8, 4)  # four eager calls' worth
    assert [g.replays for g in graphs.made] == [3]  # call 1 eager, 2 captured and replayed
    assert graphs.made[0].generators == [gen] and graphs.made[0].pools == [None]
    assert graphs.capture_seconds["k"] >= 0 and graphs.keys() == ["k"]
    assert graphs.capture_bytes == {"k": 0} and graphs.pool_bytes == 0
    # copies out: the static output is not what the caller holds
    static = graphs._entries["k"].outputs[0]
    assert all(o[0].data_ptr() != static.data_ptr() and o[1] is None for o in outs[1:])
    static.fill_(-1)
    assert torch.equal(outs[1][0], x * 2)
    for _ in range(2):  # a new key: eager, then captured in the first graph's pool
        graphs.run("other", (x,), _fake_step)
    assert graphs.made[1].pools == ["the pool"] and (K.launches, K.bwd_launches) == (12, 6)
    assert graphs.keys() == ["k", "other"]
    # a thread new to a key runs it eagerly before it may capture (its cuDNN
    # handle allocates on first use); a captured key replays from any thread
    worker = threading.Thread(target=lambda: [graphs.run(k, (x,), _fake_step)
                                              for k in ("k", "third")])
    worker.start()
    worker.join()
    assert (len(graphs.made), graphs.made[0].replays) == (2, 4)
    graphs.run("third", (x,), _fake_step)  # this thread is new to it too: eager
    assert len(graphs.made) == 2 and (K.launches, K.bwd_launches) == (18, 9)
    graphs.run("third", (x,), _fake_step)
    assert len(graphs.made) == 3 and (K.launches, K.bwd_launches) == (20, 10)
    graphs.release()  # every graph destroyed, once
    assert [g.resets for g in graphs.made] == [1, 1, 1]
    assert graphs.keys() == [] and graphs._pool is None and graphs.capture_bytes == {}
    assert graphs.pool_bytes == 0 and graphs._entries == {}
    for _ in range(2):  # the key starts over: eager, then captured in a new pool
        graphs.run("k", (x,), _fake_step)
    assert len(graphs.made) == 4 and graphs.made[3].pools == [None]
    assert (K.launches, K.bwd_launches) == (24, 12)


def test_a_failed_capture_raises_with_its_key_and_counts_nothing(monkeypatch):
    for name in K.COUNTERS:
        monkeypatch.setattr(K, name, 0)
    calls = []

    def body(x):
        calls.append(1)
        K.launches += 1
        if len(calls) == 2:  # the capture
            raise ValueError("not capturable")
        return x

    graphs = _CpuGraphs()
    graphs.run(("train", 3), (torch.ones(1),), body)  # eager
    with pytest.raises(RuntimeError, match=r"key \('train', 3\).*not capturable"):
        graphs.run(("train", 3), (torch.ones(1),), body)
    assert K.launches == 1 and graphs.keys() == [("train", 3)] and graphs._entries == {}
    # destroyed before it raised: what it recorded would hold its collectives'
    # communicators through the caller's teardown
    assert [g.resets for g in graphs.made] == [1]


def test_the_stand_in_capture_refuses_an_element_set_from_the_host():
    """The tests' stand-in graph refuses, as a CUDA capture does, a tensor
    element set from a Python number (a copy from the host: `ops/pool.py`
    did this, and a spatial grid's capture failed on it), and records the
    same element set by `fill_`."""
    def host_set(x):
        t = x.clone()
        t[0] = 0.0
        return t

    def filled(x):
        t = x.clone()
        t[:1].fill_(0.0)
        return t

    graphs = torch_dp_worker.cpu_graphs()
    for key, body in (("host", host_set), ("fill", filled)):
        assert graphs.run(key, (torch.ones(2),), body).tolist() == [0.0, 1.0]  # eager
    with pytest.raises(RuntimeError, match="operation not permitted when stream is capturing"):
        graphs.run("host", (torch.ones(2),), host_set)
    for _ in range(2):  # captured, then replayed
        assert graphs.run("fill", (torch.ones(2),), filled).tolist() == [0.0, 1.0]
    assert [g.resets for g in graphs.made] == [1, 0] and list(graphs._entries) == ["fill"]


@pytest.mark.parametrize("error", [torch.cuda.OutOfMemoryError("allocator: out of memory"),
                                   RuntimeError("CUDA error: out of memory")],
                         ids=["allocator", "runtime"])
def test_an_out_of_memory_capture_stays_out_of_memory(error):
    """Out of memory in a capture, the allocator's or the CUDA runtime's (as
    `cudaGraphInstantiate` raises it), raises `torch.cuda.OutOfMemoryError`
    with the key, for callers that size batches by it."""
    calls = []

    def body(x):
        calls.append(1)
        if len(calls) == 2:  # the capture
            raise error
        return x

    graphs = _CpuGraphs()
    graphs.run("k", (torch.ones(1),), body)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="key 'k'.*out of memory"):
        graphs.run("k", (torch.ones(1),), body)


class _SlowGraph(_StandInGraph):
    """Replays x -> 2x from the static input into the static output, slowly
    (the GIL let go before the read): a second thread's copy-in inside
    another's call would hand it the other's result."""

    def __init__(self, graphs):
        super().__init__()
        self.graphs = graphs

    def replay(self):
        super().replay()
        entry = next(iter(self.graphs._entries.values()))
        time.sleep(1e-3)
        entry.outputs[0].copy_(entry.inputs[0] * 2)


def test_threads_calling_one_step_get_their_own_outputs():
    """Two threads call one key 30 times each, each on its own input: every
    call returns its own input's result, under one graph that every call
    but the eager ones replays (a thread's first call is eager unless the
    other thread captured the key before it)."""
    graphs = _CpuGraphs()
    graphs._new_graph = lambda: graphs.made.append(_SlowGraph(graphs)) or graphs.made[-1]
    wrong, start = [], threading.Barrier(2)

    def caller(v):
        x = torch.full((4,), float(v))
        start.wait()
        for _ in range(30):
            out, _ = graphs.run("k", (x,), _fake_step)
            if not torch.equal(out, x * 2):
                wrong.append((v, out[0].item()))

    threads = [threading.Thread(target=caller, args=(v,)) for v in (1, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    eager = len(graphs._warmed["k"])
    assert wrong == [] and len(graphs.made) == 1 and eager in (1, 2)
    assert graphs.made[0].replays == 60 - eager


def _opt_layout(sd, mu_dtype):
    assert set(sd) == {"state", "param_groups"}
    for st in sd["state"].values():
        assert set(st) == {"step", "exp_avg", "exp_avg_sq"}
        assert st["step"].dtype == torch.float32 and st["step"].dim() == 0
        assert st["exp_avg"].dtype == mu_dtype and st["exp_avg_sq"].dtype == torch.float32
    for group in sd["param_groups"]:
        assert type(group["lr"]) is float


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_optimizer_checkpoints_keep_their_layout(tmp_path, moment_dtype):
    """`.pt` and `.msgpack` sets of the new optimizer state: the `.pt` layout
    (`step`, `exp_avg`, `exp_avg_sq`; a float lr), both read back equal, and
    the resumed model's next step equal to the writer's."""
    mu_dtype = getattr(torch, moment_dtype)
    model = _model(moment_dtype=moment_dtype)
    for i in range(3):
        model.train_step(*_batch(i), True, i % 2 == 0)
    ckpt.save_checkpoint(str(tmp_path / "pt"), model, 2)
    ckpt.save_jax_checkpoint(str(tmp_path / "mp"), model, 2)
    saved = torch.load(tmp_path / "pt" / "optimizer.pt", weights_only=True)
    for key in ("gen", "dis"):
        _opt_layout(saved[key], mu_dtype)
    backs = {}
    for sub in ("pt", "mp"):
        back = backs[sub] = _model(moment_dtype=moment_dtype)
        assert ckpt.load_checkpoint(str(tmp_path / sub), back) == 3
        for key in ("gen_opt", "dis_opt"):
            want, got = getattr(model, key), getattr(back, key)
            _opt_layout(got.state_dict(), mu_dtype)
            for p, q in zip(want.param_groups[0]["params"], got.param_groups[0]["params"]):
                for name, t in want.state[p].items():
                    torch.testing.assert_close(got.state[q][name], t, rtol=0, atol=0)
    # the z stream comes back with the .pt set: the next steps agree bitwise
    m1 = model.train_step(*_batch(3), True, True)
    m2 = backs["pt"].train_step(*_batch(3), True, True)
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    for n in GEN_NAMES:
        for (k, a), b in zip(model.gen(n).named_parameters(), backs["pt"].gen(n).parameters()):
            torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


def test_state_written_by_torch_adam_loads_and_continues():
    """An optimizer state in the layout `torch.optim.Adam` wrote for the
    float32 path (a CPU step tensor, its own param_groups keys) loads into
    `Adam`, and the next update equals one from the same state in
    `Adam` itself."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(6, 5), (4,)]
    start = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes] for _ in range(3)]

    def params():
        return [p.clone().requires_grad_() for p in start]

    old_p, new_p = params(), params()
    old = torch.optim.Adam(old_p, lr=1e-3, betas=(0.5, 0.999), eps=1e-8, weight_decay=1e-4)
    new = Adam(new_p, lr=1e-3, betas=(0.5, 0.999), eps=1e-8, weight_decay=1e-4)
    for gs in grads[:2]:
        for opt, ps in ((old, old_p), (new, new_p)):
            for p, g in zip(ps, gs):
                p.grad = g.clone()
            opt.step()
    loaded_p = [p.detach().clone().requires_grad_() for p in new_p]
    loaded = Adam(loaded_p, lr=5e-4)
    sd = old.state_dict()
    for st, mine in zip(sd["state"].values(), new.state.values()):
        st["exp_avg"], st["exp_avg_sq"] = mine["exp_avg"].clone(), mine["exp_avg_sq"].clone()
    loaded.load_state_dict(sd)
    assert loaded.param_groups[0]["lr"] == 1e-3
    for p, q, g in zip(new_p, loaded_p, grads[2]):
        p.grad, q.grad = g.clone(), g.clone()
    new.step()
    loaded.step()
    for p, q in zip(new_p, loaded_p):
        torch.testing.assert_close(q, p, rtol=0, atol=0)
    assert all(st["step"].item() == 3 for st in loaded.state.values())


@pytest.mark.parametrize("events, launches, ok", [
    ((98, 49), (98, 49), True),
    ((91, 49), (98, 49), True),    # the profiler lost a few events
    ((76, 0), (76, 0), True),
    ((99, 49), (98, 49), False),   # more kernels than the work launched
    ((98, 0), (98, 49), False),    # a launched kernel missing from the trace
    ((98, 1), (98, 0), False),     # a kernel that the work did not launch
])
def test_hold_trace(events, launches, ok, capsys):
    if ok:
        chip_smoke._hold_trace("traced", events, launches)
        lost = "lost" in capsys.readouterr().out
        assert lost == (events != launches)
    else:
        with pytest.raises(AssertionError, match="the traced work launches"):
            chip_smoke._hold_trace("traced", events, launches)


# ------------------------------------------------ under a data-parallel mesh
DP_WORLD, DP_BATCH = 2, 4


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    """Both gloo ranks' results of `torch_dp_worker.graph_ranks` (dis bn,
    focus masks, StepLR every 2 steps) from one initial state."""
    tmp = tmp_path_factory.mktemp("graphs_dp")
    jcfg = tiny_config(batch_size=DP_BATCH, weight_decay=1e-4, step_size=2)
    jcfg.dis.norm = "bn"
    model = ACLGAN(from_dict(jcfg.to_dict()), device="cpu", seed=5)
    model.init_state()
    snap_path = tmp / "start.pt"
    torch.save(model.snapshot(), snap_path)
    rng = np.random.RandomState(41)
    n = len(torch_dp_worker.GRAPH_SCHEDULE)
    x_a, x_b = (torch.from_numpy(rng.randint(0, 256, (n, DP_BATCH, 16, 16, 3), dtype=np.uint8))
                for _ in range(2))
    displays = [(torch.from_numpy(rng.randint(0, 256, (2, 16, 16, 3), dtype=np.uint8)),
                 torch.from_numpy(rng.randint(0, 256, (2, 16, 16, 3), dtype=np.uint8)),
                 tuple(torch.from_numpy(rng.randn(2, jcfg.gen.style_dim).astype(np.float32))
                       for _ in range(3)))
                for _ in range(3)]
    torch_dp_worker.spawn(torch_dp_worker.graph_ranks, DP_WORLD,
                          (jcfg.to_dict(), str(snap_path), x_a, x_b, displays, str(tmp)),
                          timeout=240)
    return [torch.load(tmp / f"graphs.{r}.pt", weights_only=False) for r in range(DP_WORLD)]


def test_dp_step_replayed_equals_eager(dp_ranks):
    """Five iterations (D+G, D, D+G, D+G, D: both keys eager once, captured
    once, then replayed) with drawn z: every iteration's metrics, the final
    networks and the step bit-equal to the eager data-parallel run's, K1
    counted alike per iteration, on both ranks; the ranks agree."""
    for r in dp_ranks:
        eager, graphed = r["eager"], r["graphed"]
        assert [k for k in r["keys"] if k[0] == "train"] == [
            ("train", True, gen, (2, 16, 16, 3), torch.uint8, (2, 16, 16, 3), torch.uint8, True)
            for gen in (True, False)]
        # D+G captured at iteration 3 and replayed at 4, D captured at 5;
        # sample captured at its second call and replayed at its third
        assert r["replays"] == [2, 1, 2]
        for (m_e, k_e), (m_g, k_g) in zip(eager["steps"], graphed["steps"]):
            assert k_g == k_e > 0
            assert m_g.keys() == m_e.keys()
            for k in m_e:
                assert torch.equal(m_g[k], m_e[k]), k
        for kind in ("gen", "dis"):
            for n, sd in eager[kind].items():
                for k, t in sd.items():
                    assert torch.equal(graphed[kind][n][k], t), (kind, n, k)
        assert graphed["step"] == eager["step"] == len(torch_dp_worker.GRAPH_SCHEDULE)
    for (m0, _), (m1, _) in zip(dp_ranks[0]["graphed"]["steps"], dp_ranks[1]["graphed"]["steps"]):
        assert all(torch.equal(m0[k], m1[k]) for k in m0)


def test_sample_replayed_equals_eager(dp_ranks):
    """`sample` on three display sets of one shape: eager, captured, replayed,
    each equal to the eager model's outputs, with K1 counted per call."""
    for r in dp_ranks:
        for (outs_e, k_e), (outs_g, k_g) in zip(r["eager"]["samples"], r["graphed"]["samples"]):
            assert k_g == k_e > 0
            assert len(outs_g) == len(outs_e) == 9  # focus masks: nine rows
            assert all(torch.equal(a, b) for a, b in zip(outs_g, outs_e))
        assert sum(k[0] == "sample" for k in r["keys"]) == 1


def test_capture_under_a_mesh_raises_on_every_rank(dp_ranks):
    """A key captured differently on each rank raises on both; a capture
    that fails on rank 1 alone raises there with its cause and on rank 0
    naming the other rank, both naming the key."""
    for rank, r in enumerate(dp_ranks):
        assert "capture different keys" in r["errors"]["mismatch"]
        assert f"('key of rank', {rank})" in r["errors"]["mismatch"]
        msg = r["errors"]["failed"]
        assert "('fails on rank 1',)" in msg
        assert ("not capturable here" in msg) == (rank == 1)
        assert ("on another rank" in msg) == (rank == 0)


def test_a_failed_capture_destroys_its_graph_on_every_rank(dp_ranks):
    """The capture that fails on rank 1 alone leaves no graph alive on either
    rank: each destroyed it once before raising, and kept no entry, so the
    ranks' teardown that follows (the spawn's end) waits on nothing."""
    for r in dp_ranks:
        assert r["failed_graph"] == {"resets": 1, "kept": False}


def test_two_cases_in_one_spawn_replay_equal_eager(tmp_path):
    """Two data-parallel cases (dis in, then dis bn) in one pair of gloo
    ranks, the first case's model and graphs dropped before the second is
    built, as a process that trains a second model does: each case's
    replayed third iteration, recorded by the stand-in graph at the second,
    bit-equal to its eager twin from the same state on both ranks."""
    cases = []
    for norm in ("in", "bn"):
        jcfg = tiny_config(batch_size=4, weight_decay=1e-4)
        jcfg.dis.norm = norm
        cfg = from_dict(jcfg.to_dict())
        rng = np.random.RandomState(9)
        x_a, x_b = (torch.from_numpy(rng.randint(0, 256, (4, 16, 16, 3), dtype=np.uint8))
                    for _ in range(2))
        zs = [{k: [rng.randn(4, cfg.gen.style_dim).astype(np.float32) for _ in range(3)]
               for k in ("dis", "gen")} for _ in range(3)]
        start = ACLGAN(cfg, device="cpu", seed=1)
        start.init_state()
        torch.save(start.snapshot(), tmp_path / f"start.{norm}.pt")
        cases.append((f"dis_{norm}", 2, 1, cfg.to_dict(), str(tmp_path / f"start.{norm}.pt"),
                      x_a, x_b, zs))
    torch_dp_worker.spawn(torch_dp_worker.mesh_graph_steps, 2, (cases, str(tmp_path), "cpu"),
                          timeout=240)
    key = ("train", True, True, (2, 16, 16, 3), torch.uint8, (2, 16, 16, 3), torch.uint8, False)
    for name in ("dis_in", "dis_bn"):
        for r in range(2):
            got = torch.load(tmp_path / f"mesh.{name}.{r}.pt", weights_only=False)
            assert got["keys"] == [key]
            g, e = got["graphed"], got["eager"]
            assert g["metrics"] == e["metrics"] and g["launches"] == e["launches"]
            for kind in ("gen", "dis"):
                for n, sd in e[kind].items():
                    assert all(torch.equal(g[kind][n][k], t) for k, t in sd.items()), (kind, n)


def test_spatial_step_replayed_equals_eager(tmp_path):
    """The spatial D+G step on a 2 x 2 grid of gloo ranks (halos point to
    point, the split form's all-reduces, the sharded LN / pools / bn over
    both groups): the third of three iterations, recorded by the stand-in
    graph at the second and replayed, bit-equal to the eager step from the
    same state on every rank."""
    jcfg = tiny_config(batch_size=4, weight_decay=1e-4)
    jcfg.dis.norm = "bn"
    jcfg.data.crop_image_height = jcfg.data.crop_image_width = 32
    cfg = from_dict(jcfg.to_dict())
    rng = np.random.RandomState(8)
    x_a, x_b = (torch.from_numpy(rng.randint(0, 256, (4, 32, 32, 3), dtype=np.uint8))
                for _ in range(2))
    zs = [{k: [rng.randn(4, cfg.gen.style_dim).astype(np.float32) for _ in range(3)]
           for k in ("dis", "gen")} for _ in range(3)]
    start = ACLGAN(cfg, device="cpu", seed=1)
    start.init_state()
    torch.save(start.snapshot(), tmp_path / "start.pt")
    case = ("grid", 2, 2, cfg.to_dict(), str(tmp_path / "start.pt"), x_a, x_b, zs)
    torch_dp_worker.spawn(torch_dp_worker.mesh_graph_steps, 4, ([case], str(tmp_path), "cpu"),
                          timeout=240)
    for r in range(4):
        got = torch.load(tmp_path / f"mesh.grid.{r}.pt", weights_only=False)
        assert got["keys"] == [("train", True, True, (2, 16, 32, 3), torch.uint8,
                                (2, 16, 32, 3), torch.uint8, False)]
        g, e = got["graphed"], got["eager"]
        assert g["metrics"] == e["metrics"]
        for kind in ("gen", "dis"):
            for n, sd in e[kind].items():
                assert all(torch.equal(g[kind][n][k], t) for k, t in sd.items()), (kind, n)
