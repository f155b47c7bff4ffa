"""The port's `BucketedTranslator` and `AsyncTranslator` against the JAX
serving stack on one `.pt` checkpoint written by the port, plus the async
contract of `tests/test_serving.py` on the port.

n_res 4: the JAX Translator maps a `.pt` with the default GenConfig.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from aclgan_tpu.serving import BucketedTranslator as JBucketed
from aclgan_tpu.serving import Translator as JTranslator
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.serving import AsyncTranslator, BucketedTranslator, Translator
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import save_generators
from tests.helpers import tiny_config

BUCKETS = (8, 16, 24)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    torch.set_num_threads(1)
    jcfg = tiny_config()
    jcfg.gen.n_res = 4
    cfg = from_dict(jcfg.to_dict())
    path = str(tmp_path_factory.mktemp("stack") / "gen_00000000.pt")
    save_generators(path, ACLGAN(cfg, device="cpu", seed=0))
    port = BucketedTranslator(cfg, path, buckets=BUCKETS, batch_size=2, device="cpu")
    ref = JBucketed(jcfg, path, buckets=BUCKETS, batch_size=2)
    return jcfg, cfg, path, port, ref


def _lsb(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def test_bucketed_matches_jax_on_mixed_sizes(stack):
    _, cfg, _, port, ref = stack
    rng = np.random.RandomState(0)
    # shortest sides 7, 8, 14, 30, 16, 20 -> buckets 8, 8, 16, 24, 16, 24
    shapes = [(7, 12), (13, 8), (14, 19), (30, 35), (16, 16), (27, 20)]
    imgs = [rng.randint(0, 256, s + (3,), dtype=np.uint8) for s in shapes]
    styles = rng.randn(len(imgs), cfg.gen.style_dim).astype(np.float32)
    outs, masks = port(imgs, styles, return_masks=True)
    want, want_masks = ref(imgs, styles, return_masks=True)
    assert [o.shape[0] for o in outs] == [8, 8, 16, 24, 16, 24]
    for o, w, m, wm in zip(outs, want, masks, want_masks):
        assert o.shape == w.shape and o.dtype == np.uint8
        assert _lsb(o, w) <= 1
        np.testing.assert_allclose(m, wm, rtol=1e-4, atol=1e-4)


def test_pick_bucket_matches_jax(stack):
    *_, port, ref = stack
    for h in range(1, 40, 3):
        for w in (h, h + 5, max(1, h - 4)):
            img = np.zeros((h, w, 3), np.uint8)
            assert port.pick_bucket(img) == ref.pick_bucket(img), (h, w)


@pytest.mark.parametrize("buckets", [(10,), (8, 12, 0), (-4,)])
def test_bucketed_rejects_bad_stride_like_jax(stack, buckets):
    jcfg, cfg, path, *_ = stack
    with pytest.raises(ValueError, match="stride"):
        BucketedTranslator(cfg, path, buckets=buckets, device="cpu")
    with pytest.raises(ValueError, match="stride"):
        JBucketed(jcfg, path, buckets=buckets)


def test_bucketed_menu_sorted_and_deduplicated(stack):
    _, cfg, path, *_ = stack
    tr = BucketedTranslator(cfg, path, buckets=(16, 8, 16), device="cpu")
    assert tr.buckets == (8, 16)


def test_bucketed_warmup_and_compiled_shapes(stack):
    _, cfg, path, *_ = stack
    tr = BucketedTranslator(cfg, path, buckets=(8, 12), batch_size=2, device="cpu")
    assert tr.compiled_shapes() == 0
    tr.warmup()
    assert tr.compiled_shapes() == 2
    rng = np.random.RandomState(3)
    for _ in range(2):  # repeat traffic over both buckets, tails padded
        tr([rng.randint(0, 256, (s, s + 3, 3), dtype=np.uint8) for s in (6, 8, 11, 12, 40)])
    assert tr.compiled_shapes() == 2


def test_bucketed_defaults_to_cuda(stack):
    _, cfg, path, *_ = stack
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        BucketedTranslator(cfg, path)


def test_async_coalesced_outputs_match_jax_translator(stack):
    jcfg, cfg, path, *_ = stack
    tr = Translator(cfg, path, batch_size=4, size=16, device="cpu")
    ref = JTranslator(jcfg, path, batch_size=4, size=16)
    rng = np.random.RandomState(1)
    imgs = [rng.randint(0, 256, (16, 20, 3), dtype=np.uint8) for _ in range(6)]
    styles = rng.randn(6, cfg.gen.style_dim).astype(np.float32)
    with AsyncTranslator(tr, max_batch=4, max_wait_ms=200.0) as srv:
        futs = [srv.submit(im, style=s) for im, s in zip(imgs, styles)]
        outs = [f.result(timeout=60) for f in futs]
    want = ref(imgs, styles)
    for o, w in zip(outs, want):
        assert o.shape == (16, 16, 3) and _lsb(o, w) <= 1


def test_async_batches_concurrent_requests(stack):
    _, cfg, path, *_ = stack
    base = BucketedTranslator(cfg, path, buckets=(8, 16), batch_size=4, seed=4,
                              device="cpu")
    calls = []
    orig = BucketedTranslator.__call__

    def counting(self, images, **kw):
        calls.append(len(images))
        return orig(self, images, **kw)

    base.__class__ = type("Counting", (BucketedTranslator,), {"__call__": counting})
    rng = np.random.RandomState(4)
    with AsyncTranslator(base, max_batch=4, max_wait_ms=200.0) as srv:
        futs = [srv.submit(rng.randint(0, 256, (8 + 8 * (i % 2),) * 2 + (3,),
                                       dtype=np.uint8))
                for i in range(8)]
        outs = [f.result(timeout=60) for f in futs]
    for i, o in enumerate(outs):
        assert o.shape == (8 + 8 * (i % 2), 8 + 8 * (i % 2), 3)
        assert o.dtype == np.uint8
    # 8 requests coalesced into batched calls, not 8 singletons
    assert len(calls) <= 4 and max(calls) > 1


def test_async_style_and_errors(stack):
    _, cfg, path, *_ = stack
    tr = Translator(cfg, path, batch_size=2, size=16, seed=5, device="cpu")
    img = np.random.RandomState(5).randint(0, 256, (16, 16, 3), np.uint8)
    z = np.zeros((cfg.gen.style_dim,), np.float32)
    with AsyncTranslator(tr, max_wait_ms=1.0) as srv:
        a = srv.translate(img, style=z)
        b = srv.translate(img, style=z)
        np.testing.assert_array_equal(a, b)  # deterministic given style
        bad = srv.submit(np.zeros((16, 16, 4), np.uint8))  # 4-channel input
        with pytest.raises(ValueError, match="RGB"):
            bad.result(timeout=60)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(img)


def test_async_bad_request_fails_alone(stack):
    _, cfg, path, *_ = stack
    tr = Translator(cfg, path, batch_size=4, size=16, seed=6, device="cpu")
    good_img = np.random.RandomState(6).randint(0, 256, (16, 16, 3), np.uint8)
    with AsyncTranslator(tr, max_batch=4, max_wait_ms=300.0) as srv:
        f_good1 = srv.submit(good_img)
        f_bad_img = srv.submit(np.zeros((16, 16, 4), np.uint8))
        f_bad_style = srv.submit(good_img, style=np.zeros((cfg.gen.style_dim + 3,),
                                                          np.float32))
        f_good2 = srv.submit(good_img)
        assert f_good1.result(timeout=60).shape == (16, 16, 3)
        assert f_good2.result(timeout=60).shape == (16, 16, 3)
        with pytest.raises(ValueError, match="RGB"):
            f_bad_img.result(timeout=60)
        with pytest.raises(ValueError, match="style"):
            f_bad_style.result(timeout=60)
        assert srv.submit(good_img).result(timeout=60).dtype == np.uint8


def test_async_close_drains_in_flight(stack):
    _, cfg, path, *_ = stack
    tr = Translator(cfg, path, batch_size=2, size=16, seed=7, device="cpu")
    img = np.random.RandomState(7).randint(0, 256, (16, 16, 3), np.uint8)
    srv = AsyncTranslator(tr, max_wait_ms=1.0)
    futs = [srv.submit(img) for _ in range(5)]
    srv.close(drain=True)
    for f in futs:
        assert f.result(timeout=1).shape == (16, 16, 3)


def test_async_cancelled_future_does_not_poison_batch(stack):
    _, cfg, path, *_ = stack
    tr = Translator(cfg, path, batch_size=4, size=16, seed=8, device="cpu")
    img = np.random.RandomState(8).randint(0, 256, (16, 16, 3), np.uint8)
    srv = AsyncTranslator(tr, max_batch=4, max_wait_ms=300.0)
    try:
        f1 = srv.submit(img)
        f_cancel = srv.submit(img)
        f_cancel.cancel()  # may race the worker; either way must be benign
        f2 = srv.submit(img)
        assert f1.result(timeout=60).shape == (16, 16, 3)
        assert f2.result(timeout=60).shape == (16, 16, 3)
        assert srv.submit(img).result(timeout=60).dtype == np.uint8
    finally:
        srv.close(drain=True)  # must not hang on a leaked pending count
    assert srv._pending == 0
    with pytest.raises(RuntimeError):
        srv.submit(img)


class _Echo:
    """A duck-typed translator: no model, returns each image plus one."""
    batch_size = 4
    style_dim = 3

    def __init__(self):
        self.lock = threading.Lock()
        self.draws = 0

    def random_style(self, n):
        with self.lock:
            self.draws += 1
        return np.zeros((n, self.style_dim), np.float32)

    def __call__(self, images, styles=None):
        assert len(images) == len(styles) <= self.batch_size
        return [im + 1 for im in images]


def test_async_stress_many_submitters_no_lost_request():
    """More submitting threads than cores, a tiny switch interval: every
    future resolves with its own image, and the pending count returns to 0."""
    echo = _Echo()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        srv = AsyncTranslator(echo, max_wait_ms=0.5)
        results = {}

        def client(t):
            futs = [(i, srv.submit(np.full((2, 2, 3), (t * 8 + i) % 200, np.uint8)))
                    for i in range(8)]
            results[t] = [(i, f.result(timeout=30)) for i, f in futs]

        threads = [threading.Thread(target=client, args=(t,)) for t in range(24)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        srv.close(drain=True)
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 24 and srv._pending == 0
    for t, got in results.items():
        for i, out in got:
            assert int(out[0, 0, 0]) == (t * 8 + i) % 200 + 1
    assert not srv._worker.is_alive()
