"""The port stands alone: no JAX and nothing of `aclgan_tpu` in it, and its own
config reader agrees with the JAX package's on every shipped config."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from aclgan_tpu import config as jconfig
from aclgan_tpu_torch import config

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "aclgan_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
# msgpack too: the GPU host has no msgpack package (utils/msgpack.py reads the format)
_FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "msgpack"}


def _forbidden(module: str) -> bool:
    return (module.split(".")[0] in _FORBIDDEN_ROOTS
            or module == "aclgan_tpu" or module.startswith("aclgan_tpu."))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                found.append(node.module)
    assert not found, f"{path}: imports {found}"


def test_forbidden_matches_exactly():
    assert _forbidden("aclgan_tpu") and _forbidden("aclgan_tpu.config")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert not _forbidden("aclgan_tpu_torch") and not _forbidden("aclgan_tpu_torch.config")
    assert _forbidden("msgpack") and not _forbidden("aclgan_tpu_torch.utils.msgpack")


def test_serving_import_loads_no_jax():
    code = ("import sys, aclgan_tpu_torch.serving; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'aclgan_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_train_cli_import_loads_no_jax():
    code = ("import sys, aclgan_tpu_torch.cli.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'aclgan_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("module", ["test", "test_batch", "train_inception", "fid_curve"])
def test_eval_cli_import_loads_no_jax(module):
    code = (f"import sys, aclgan_tpu_torch.cli.{module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'aclgan_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("module", ["serving_http", "export", "cli.export"])
def test_serving_stack_import_loads_no_jax(module):
    code = (f"import sys, aclgan_tpu_torch.{module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'aclgan_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("module", ["optim", "ops.spectral", "cli.convert", "data.native",
                                    "parallel.mesh", "models.vgg"])
def test_training_modules_import_loads_no_jax(module):
    code = (f"import sys, aclgan_tpu_torch.{module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'aclgan_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_reader_matches_jax(path):
    # repr, not ==, so that an int read as a float (or the reverse) fails
    assert repr(config.load_config(path).to_dict()) == repr(jconfig.load_config(path).to_dict())


def test_yaml_subset_matches_pyyaml():
    text = """\
# comment line
a: 1            # trailing comment
b: 0.5
c: 1e-4
d: 1.0e-4
e: -3
f: true
g: Off
h: null
i: ~
j: 'quoted # not a comment'
k: "x: y"
l: plain text
m: .inf
n:
sect:
  x: 2
  y: no
  z:
empty:
  # nothing but a comment
"""
    assert config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("raw,match", [
    ({"bogus": 1}, "Unknown config key"),
    ({"gen": {"dim": 8, "bogus": 1}}, "Unknown gen config keys"),
    ({"tpu": 3}, "must be a mapping"),
])
def test_unknown_keys_rejected_like_jax(raw, match):
    with pytest.raises(ValueError, match=match):
        config.from_dict(raw)
    with pytest.raises(ValueError, match=match):
        jconfig.from_dict(raw)


@pytest.mark.parametrize("text", ["a:\n    b:\n      c: 1\n", "  a: 1\n", "a 1\n"])
def test_yaml_reader_rejects_what_it_cannot_read(text):
    with pytest.raises(ValueError):
        config.parse_yaml(text)
