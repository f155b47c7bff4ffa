"""The port's flax msgpack reader (`aclgan_tpu_torch.utils.msgpack`) against
`flax.serialization`, and JAX generator snapshots (`gen_%08d.msgpack`)
loaded into the port (`utils.checkpoint.load_generators`)."""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from aclgan_tpu.trainer import ACLGAN as JACLGAN
from aclgan_tpu.utils.checkpoint import save_checkpoint
from aclgan_tpu_torch.config import from_dict
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils import checkpoint as ckpt
from aclgan_tpu_torch.utils.msgpack import loads, read_msgpack
from tests.helpers import tiny_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    """Every kind of leaf flax writes, with lengths that take each msgpack
    size class (fix, 8-, 16- and 32-bit)."""
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 5).astype(np.float32),
        "big_f32": rng.randn(70_000).astype(np.float32),  # bin32
        "bf16": jnp.asarray(rng.randn(4, 7), jnp.bfloat16),
        "i32": rng.randint(-2**31, 2**31 - 1, (2, 3, 4), dtype=np.int32),
        "u32": np.array([0, 1, 2**32 - 1], np.uint32),
        "f64": rng.randn(2).astype(np.float64),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float32),
        "scalars": {"f32": np.float32(1.5), "i32": np.int32(-7), "f64": np.float64(2.25),
                    "bf16": jnp.bfloat16(3.0)},
        "py": {"int": 5, "neg": -33, "i16": -300, "u16": 60_000, "i64": -2**40,
               "u64": 2**63 + 1, "float": 0.1, "none": None, "t": True, "f": False,
               "short": "x", "long": "s" * 40, "longer": "t" * 300, "bytes": b"\x00\x01"},
        "list": [np.arange(3, dtype=np.int32), 1.0, "z"],
        "many": {f"k{i:02d}": np.float32(i) for i in range(20)},   # map16
        "long_list": list(range(20)),                              # array16
    }


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        w = np.asarray(want)
        assert isinstance(got, torch.Tensor), path
        assert str(got.dtype).split(".")[-1] == w.dtype.name, path
        assert tuple(got.shape) == w.shape, path
        # bit for bit: the raw bytes
        assert got.reshape(-1).view(torch.uint8).numpy().tobytes() == w.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def test_reader_matches_flax_bit_for_bit():
    blob = flax.serialization.msgpack_serialize(_tree())
    _assert_same(loads(blob), flax.serialization.msgpack_restore(blob))


def test_reader_refuses_what_it_cannot_read():
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True,
                                   "shape": {"0": 4}, "chunks": {"0": 1}}})
    with pytest.raises(ValueError, match="chunk"):
        loads(chunked)
    blob = flax.serialization.msgpack_serialize({"a": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        loads(blob[:-3])
    with pytest.raises(ValueError, match="after the msgpack object"):
        loads(blob + b"\x00")
    with pytest.raises(ValueError, match="extension type 9"):
        loads(msgpack.packb(msgpack.ExtType(9, b"x")))
    with pytest.raises(ValueError, match="0xc1"):
        loads(b"\xc1")


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    """A tiny-config JAX snapshot set, written by the JAX package."""
    jcfg = tiny_config()
    jmodel = JACLGAN(jcfg)
    state = jmodel.init_state(jax.random.PRNGKey(3))
    root = tmp_path_factory.mktemp("jax_ckpt")
    save_checkpoint(str(root), state, 19, rng_key=jax.random.PRNGKey(5))
    return jcfg, jmodel, state, str(root / "gen_00000020.msgpack")


def test_reader_reads_the_jax_checkpoint_files(jax_snapshot):
    """gen / dis / optimizer files of the JAX package, as written."""
    root = os.path.dirname(jax_snapshot[-1])
    for name in ("gen_00000020.msgpack", "dis_00000020.msgpack", "optimizer.msgpack"):
        with open(os.path.join(root, name), "rb") as f:
            blob = f.read()
        _assert_same(read_msgpack(os.path.join(root, name)),
                     flax.serialization.msgpack_restore(blob))


@pytest.mark.parametrize("a2b", [True, False])
def test_jax_generator_snapshot_translates_as_jax(jax_snapshot, a2b):
    """A JAX `gen_%08d.msgpack` loads into the port, and `translate` matches
    the JAX `ACLGAN.translate` on the same images and styles at 1e-4."""
    jcfg, jmodel, state, path = jax_snapshot
    model = ACLGAN(from_dict(jcfg.to_dict()), device="cpu", seed=11)
    ckpt.load_generators(path, model)
    rng = np.random.RandomState(4)
    x = rng.randint(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    z = rng.randn(3, jcfg.gen.style_dim).astype(np.float32)
    img, mask = model.translate(torch.from_numpy(x), torch.from_numpy(z), a2b=a2b)
    jimg, jmask = jmodel.translate(state.gen_params, jnp.asarray(x), jnp.asarray(z), a2b=a2b)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mask.numpy(), np.asarray(jmask), rtol=1e-4, atol=1e-4)


def test_snapshot_discovery_takes_both_suffixes(jax_snapshot, tmp_path):
    *_, path = jax_snapshot
    model = ACLGAN(from_dict(tiny_config().to_dict()), device="cpu")
    d = tmp_path / "checkpoints"
    d.mkdir()
    ckpt.save_generators(str(d / "gen_00000010.pt"), model)
    (d / "gen_00000020.msgpack").write_bytes(open(path, "rb").read())
    (d / "ema_00000020.msgpack").write_bytes(b"")
    os.symlink(d / "gen_00000010.pt", d / "gen_00000099.pt")  # an alias, left out
    (d / "gen_00000030.msgpack.tmp").write_bytes(b"")         # a torn write
    snaps = ckpt.list_snapshots(str(d), "gen")
    assert [os.path.basename(s) for s in snaps] == ["gen_00000010.pt",
                                                     "gen_00000020.msgpack"]
    assert [ckpt.parse_iteration(s) for s in snaps] == [10, 20]
    for s in snaps:
        ckpt.load_generators(s, model)
