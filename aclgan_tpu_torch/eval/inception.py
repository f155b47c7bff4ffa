"""InceptionV3 for IS / conditional IS / FID, NCHW, in torchvision's layout.

Port of `aclgan_tpu/eval/inception.py`: the standard topology
(`BasicConv2d` = conv without bias + BatchNorm(eps 1e-3, running statistics)
+ relu; blocks A-E; no aux head), `transform_input` on [0, 1] inputs, pool3
as the spatial mean. Module and parameter names are torchvision's
(`Conv2d_1a_3x3.conv.weight`, `Mixed_7c.branch_pool.bn.running_var`, `fc`),
so a torchvision `inception_v3` state_dict, fine-tuned or not, loads with
`load_state_dict` as it is (its `AuxLogits.*` entries are dropped).

`InceptionScorer` takes NHWC [0, 1] numpy batches of any size, resizes them
to 299x299 (bilinear with antialiasing, which equals `jax.image.resize(...,
"bilinear")` when shrinking as well as when growing) and returns softmax
predictions or pool3 features. Its weights come from a torch `.pt` (a
state_dict or a pickled module), from a flax `.msgpack` (the JAX package's
`tools/train_inception.py` writes one; read by `utils/msgpack.py`), or, with
no file, from a seeded random init (`pretrained = False`).

Precision: the scorer and the fine-tune run in full float32. cuDNN would run
float32 convolutions in TF32 by default, which moves pool3 features by about
1e-3 relative; `full_f32()` turns that off around each call.
"""

from __future__ import annotations

import contextlib
import math
import pickle
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aclgan_tpu_torch.trainer import resolve_device
from aclgan_tpu_torch.utils.msgpack import read_msgpack

SIZE = 299
_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """cuDNN convolutions in full float32 (no TF32) inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


Pad = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    # flax avg_pool counts the padding (the discriminator's pool does not)
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool(x))], 1)


# torchvision's transform_input, applied to [0, 1] inputs as the JAX model does
_TRANSFORM_SCALE = (0.229 / 0.5, 0.224 / 0.5, 0.225 / 0.5)
_TRANSFORM_SHIFT = ((0.485 - 0.5) / 0.5, (0.456 - 0.5) / 0.5, (0.406 - 0.5) / 0.5)


class InceptionV3(nn.Module):
    """Standard InceptionV3 without the aux head. Input NCHW in [0, 1]."""

    def __init__(self, num_classes: int = 1000, transform_input: bool = True,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.transform_input = transform_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)
        self.reset_parameters(gen)

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        """flax's defaults: lecun-normal (truncated) kernels, zero fc bias,
        BatchNorm at scale 1, shift 0 and identity statistics."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / (m.weight[0].numel())) / _TRUNC
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """pool3 features (N, 2048)."""
        if self.transform_input:
            scale = x.new_tensor(_TRANSFORM_SCALE).view(1, 3, 1, 1)
            shift = x.new_tensor(_TRANSFORM_SHIFT).view(1, 3, 1, 1)
            x = x * scale + shift
        else:
            x = x * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(2, 3))

    def forward(self, x: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        feats = self.features(x)
        return feats if return_features else self.fc(feats)


def _leaves(tree: dict, path: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


_FLAX_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def flax_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """flax InceptionV3 variables ({'params', 'batch_stats'}) -> torchvision
    state_dict: the inverse of `aclgan_tpu/eval/inception.py::
    _import_torch_inception` (HWIO -> OIHW, Dense (in, out) -> (out, in),
    `scale` -> `weight`, `mean` / `var` -> `running_mean` / `running_var`)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables["params"]):
        key, name = ".".join(path[:-1]), path[-1]
        w = torch.as_tensor(leaf).float()
        if name == "kernel":
            w = w.permute(3, 2, 0, 1) if w.ndim == 4 else w.t()
        sd[f"{key}.{_FLAX_TO_TORCH[name]}"] = w.contiguous()
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        key, name = ".".join(path[:-1]), path[-1]
        sd[f"{key}.running_{name}"] = torch.as_tensor(leaf).float()
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
    return sd


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision-layout state_dict from a `.msgpack` or a `.pt` file."""
    if path.endswith(".msgpack"):
        return flax_state_dict(read_msgpack(path))
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # a whole pickled module (torch.save(model))
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v for k, v in obj.items() if not k.startswith("AuxLogits.")}


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """NCHW images -> NCHW at 299x299, as `jax.image.resize(..., "bilinear")`."""
    return F.interpolate(x, size=(SIZE, SIZE), mode="bilinear", align_corners=False,
                         antialias=True)


class InceptionScorer:
    """Softmax predictions and pool3 features at 299x299, on `device`."""

    def __init__(self, weights_path: Optional[str] = None, num_classes: int = 1000,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.pretrained = bool(weights_path) and weights_path != "."
        if self.pretrained:
            sd = load_state_dict_file(weights_path)
            num_classes = sd["fc.weight"].shape[0] if "fc.weight" in sd else num_classes
            self.model = InceptionV3(num_classes)
            self.model.load_state_dict(sd)
        else:
            self.model = InceptionV3(num_classes, gen=torch.Generator().manual_seed(0))
        self.model.to(self.device).eval()

    def _run(self, images01: np.ndarray, return_features: bool) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(images01, np.float32)).to(self.device)
        with torch.inference_mode(), full_f32():
            return self.model(resize_299(x.permute(0, 3, 1, 2)), return_features)

    def predict(self, images01: np.ndarray) -> np.ndarray:
        """images01: NHWC float in [0,1] -> (N, num_classes) softmax."""
        return torch.softmax(self._run(images01, False), dim=-1).cpu().numpy()

    def features(self, images01: np.ndarray) -> np.ndarray:
        """pool3 features (N, 2048) for FID."""
        return self._run(images01, True).cpu().numpy()
