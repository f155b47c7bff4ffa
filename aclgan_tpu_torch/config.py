"""Typed configuration schema + a YAML reader and writer that need no PyYAML.

The schema is the JAX package's (`aclgan_tpu/config.py`): the same
dataclasses, field names, defaults and unknown-key rejection, so one YAML file
configures both packages. The `tpu:` block is accepted whole; of its knobs
the port reads `compute_dtype` (conv/dense compute type; params stay
float32) and `ema_decay`, and refuses the training knobs it has not ported
(`grad_accum > 1`, `remat`, `moment_dtype` other than float32). The others
are TPU/XLA knobs the port ignores.

`load_config` parses the YAML subset `configs/*.yaml` uses — `key: scalar`
lines, one level of nested mappings, `#` comments — with PyYAML's YAML 1.1
scalar rules for null, bool, int and float, and `save_config` writes that
subset back, so neither needs PyYAML, which the GPU host may lack.
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional, Union


@dataclass
class GenConfig:
    """Generator architecture (reference `gen:` block)."""

    dim: int = 64            # filters in the bottommost layer
    mlp_dim: int = 256       # width of the AdaIN-parameter MLP
    style_dim: int = 8       # length of the style code
    output_dim: int = 4      # decoder output channels (3 RGB + 1 focus mask)
    activ: str = "relu"      # relu/lrelu/prelu/selu/tanh
    n_downsample: int = 2    # downsampling convs in the content encoder
    n_res: int = 4           # residual blocks in content encoder / decoder
    pad_type: str = "reflect"  # zero/reflect/replicate


@dataclass
class DisConfig:
    """Discriminator architecture (reference `dis:` block)."""

    dim: int = 64
    norm: str = "none"       # none/bn/in/ln/sn
    activ: str = "lrelu"
    n_layer: int = 4
    gan_type: str = "lsgan"  # lsgan/nsgan
    num_scales: int = 3
    pad_type: str = "reflect"


@dataclass
class DataConfig:
    """Data pipeline options."""

    input_dim_a: int = 3
    input_dim_b: int = 6     # channels seen by the consistency discriminator (pairs)
    num_workers: int = 8
    new_size: Optional[int] = 256     # resize shortest side
    new_size_a: Optional[int] = None  # per-domain override
    new_size_b: Optional[int] = None
    crop_image_height: int = 256
    crop_image_width: int = 256
    data_root: Optional[str] = None   # folder mode: trainA/trainB/testA/testB
    data_kind: str = ""
    data_folder_train_a: Optional[str] = None
    data_list_train_a: Optional[str] = None
    data_folder_test_a: Optional[str] = None
    data_list_test_a: Optional[str] = None
    data_folder_train_b: Optional[str] = None
    data_list_train_b: Optional[str] = None
    data_folder_test_b: Optional[str] = None
    data_list_test_b: Optional[str] = None
    synthetic: bool = False

    def resolved_sizes(self) -> tuple[Optional[int], Optional[int]]:
        if self.new_size is not None:
            return self.new_size, self.new_size
        return self.new_size_a, self.new_size_b


@dataclass
class TpuConfig:
    """The JAX package's `tpu:` block. The port reads `compute_dtype` and the
    training knobs (`ema_decay`; `grad_accum`, `remat` and `moment_dtype`
    only to refuse what is not ported); the rest are TPU/XLA knobs, kept so
    the same YAML files validate."""

    compute_dtype: str = "bfloat16"   # dtype of conv/matmul compute; params stay f32
    use_pallas: bool = False
    fast_upsample: bool = True
    mesh_data: int = -1
    mesh_spatial: int = 1
    prefetch: int = 2
    donate_state: bool = True
    check_nans: bool = False
    snapshot_keep: int = 0
    distributed: bool = False
    remat: Union[bool, str] = False
    moment_dtype: str = "float32"
    grad_accum: int = 1
    ema_decay: float = 0.0
    uint8_transfer: bool = True


@dataclass
class Config:
    # logger options
    image_save_iter: int = 10000
    image_display_iter: int = 1000
    display_size: int = 16
    snapshot_save_iter: int = 10000
    log_iter: int = 1

    # optimization options
    max_iter: int = 350000
    batch_size: int = 3
    weight_decay: float = 0.0001
    beta1: float = 0.5
    beta2: float = 0.999
    init: str = "kaiming"            # gaussian/kaiming/xavier/orthogonal/default
    lr: float = 0.0001
    lr_policy: str = "step"          # constant/step
    step_size: int = 100000
    gamma: float = 0.5
    gan_w: float = 1.0
    gan_cw: float = 0.2              # consistency ("council") loss weight
    focus_loss: float = 0.025        # focus-mask loss weight (0 disables masks)
    focus_delta: float = 0.001
    focus_upper: float = 0.5
    focus_lower: float = 0.3
    focus_epsilon: float = 0.01
    recon_x_w: float = 1.0
    recon_s_w: float = 1.0
    recon_c_w: float = 1.0
    recon_x_cyc_w: float = 1.0
    vgg_w: float = 0.0
    alpha: float = 1.0
    G_update: int = 2
    D_update: int = 1

    gen: GenConfig = field(default_factory=GenConfig)
    dis: DisConfig = field(default_factory=DisConfig)
    data: DataConfig = field(default_factory=DataConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    vgg_model_path: Optional[str] = None
    seed: int = 0

    @property
    def style_dim(self) -> int:
        return self.gen.style_dim

    @property
    def use_focus(self) -> bool:
        return self.focus_loss > 0

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


_NESTED = {"gen": GenConfig, "dis": DisConfig, "data": DataConfig, "tpu": TpuConfig}

# top-level YAML keys that belong to the DataConfig block (reference configs
# keep data options at the top level)
_DATA_KEYS = {f.name for f in dataclasses.fields(DataConfig)}


def from_dict(raw: dict[str, Any]) -> Config:
    """Build a Config from a (reference-compatible, flat) YAML dict.

    Unknown keys raise — the schema is the contract.
    """
    raw = dict(raw)
    kwargs: dict[str, Any] = {}
    data_kwargs: dict[str, Any] = {}
    cfg_fields = {f.name for f in dataclasses.fields(Config)}
    for key, value in raw.items():
        if key in _NESTED:
            # an empty section ("tpu:" with every knob commented out) means
            # defaults; a scalar is a user error that must fail here
            if value is None:
                value = {}
            if not isinstance(value, dict):
                raise ValueError(
                    f"config section {key!r} must be a mapping, got "
                    f"{type(value).__name__}: {value!r}")
            cls = _NESTED[key]
            valid = {f.name for f in dataclasses.fields(cls)}
            unknown = set(value) - valid
            if unknown:
                raise ValueError(f"Unknown {key} config keys: {sorted(unknown)}")
            kwargs[key] = cls(**value)
        elif key in _DATA_KEYS:
            data_kwargs[key] = value
        elif key in cfg_fields:
            kwargs[key] = value
        else:
            raise ValueError(f"Unknown config key: {key!r}")
    if data_kwargs:
        base = kwargs.get("data", DataConfig())
        kwargs["data"] = dataclasses.replace(base, **data_kwargs)
    return Config(**kwargs)


# YAML 1.1 implicit scalars, as PyYAML's SafeLoader resolves them
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_INF_NAN = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
            ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}


def _scalar(text: str) -> Any:
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    unsigned = text.lstrip("+-")
    if unsigned in _INF_NAN:
        return -_INF_NAN[unsigned] if text.startswith("-") else _INF_NAN[unsigned]
    return text


def _strip_comment(line: str) -> str:
    """Drop a `#` comment: one that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> dict[str, Any]:
    """Parse `key: scalar` lines with at most one level of nested mappings."""
    out: dict[str, Any] = {}
    section: Optional[str] = None  # top-level key whose value is a mapping
    child_indent = 0
    for lineno, raw_line in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw_line).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, value = line.strip().partition(":")
        if not sep or (value and not value.startswith(" ")) or not key:
            raise ValueError(f"line {lineno}: expected 'key: value', got {raw_line!r}")
        value = value.strip()
        if indent == 0:
            out[key] = _scalar(value)
            section = key if value == "" else None
            child_indent = 0
        elif section is None:
            raise ValueError(f"line {lineno}: indented line outside a section")
        elif child_indent not in (0, indent):
            raise ValueError(f"line {lineno}: only one level of nesting is supported")
        else:
            child_indent = indent
            if out[section] is None:
                out[section] = {}
            out[section][key] = _scalar(value)
    return out


def load_config(path: Union[str, os.PathLike]) -> Config:
    """Load a YAML config file."""
    with open(path, "r") as stream:
        raw = parse_yaml(stream.read())
    return from_dict(raw)


_PLAIN = re.compile(r"[A-Za-z_/][A-Za-z0-9_./-]*")


def _dump_scalar(value: Any) -> str:
    """One scalar as `parse_yaml` and PyYAML both read it back: floats keep a
    `.` (YAML 1.1 reads `1e-05` as a string), and a string is quoted unless
    it is a plain word that no other scalar type claims."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "." not in text:
            text = text.replace("e", ".0e")
        return text
    if isinstance(value, str):
        if _PLAIN.fullmatch(value) and _scalar(value) == value:
            return value
        for quote in "'\"":
            if quote not in value and "\\" not in value and "\n" not in value:
                return f"{quote}{value}{quote}"
    raise ValueError(f"cannot write {value!r} in the YAML subset parse_yaml reads")


def save_config(cfg: Config, path: Union[str, os.PathLike]) -> None:
    """Snapshot the config next to the outputs, as `yaml.safe_dump` would
    (`aclgan_tpu/config.py:254-257`), in the subset `load_config` reads: the
    GPU host has no PyYAML."""
    lines = []
    for key, value in cfg.to_dict().items():
        if isinstance(value, dict):
            lines.append(f"{key}:")
            lines += [f"  {k}: {_dump_scalar(v)}" for k, v in value.items()]
        else:
            lines.append(f"{key}: {_dump_scalar(value)}")
    with open(path, "w") as stream:
        stream.write("\n".join(lines) + "\n")
