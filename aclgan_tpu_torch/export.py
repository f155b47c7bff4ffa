"""Export: a self-contained serving artifact via `torch.export`.

Port of `aclgan_tpu/export.py`. `export_translator` freezes one checkpointed
generator into a `torch.export.ExportedProgram` of the uint8-in / uint8-out
translation step (`serving.translate_u8`: content encode -> AdaIN decode ->
focus blend -> uint8), with the weights embedded. The artifact:

- needs `torch` and `aclgan_tpu_torch.ops.kernels.instance_norm` (which
  registers the `aclgan::instance_norm_fwd` op, K1) to run: no model code,
  no checkpoint loader, no config parsing at serve time;
- holds K1 as one graph node per instance-norm layer (19 at the shipped
  depth), so it launches the CUDA kernel on the card whatever device it was
  traced on, and the plain version on the CPU;
- has static shapes (batch, size, size, 3) uint8 and (batch, style_dim)
  float32, the same contract as `serving.Translator`.

File layout (format 1), as the JAX package's with a magic of the port's own,
so that each package's loader refuses the other's file:
    8-byte magic  b"ACLGPT01"
    4-byte little-endian JSON header length
    JSON header   (format/batch_size/size/a2b/style_dim/focus/torch_version/device)
    payload       `torch.export.save` bytes

Use `export_translator` + `save_artifact` (or `cli/export.py`) to produce
one, and `ExportedTranslator` (or `load_artifact()[0].module()`) to serve it.
"""

from __future__ import annotations

import io
import json
import struct
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from aclgan_tpu_torch.data.transforms import prep_image
from aclgan_tpu_torch.ops.kernels import instance_norm  # noqa: F401  registers K1's op

_MAGIC = b"ACLGPT01"
_FORMAT = 1


class _TranslateStep(torch.nn.Module):
    """`serving.translate_u8` as a module holding only the direction's
    generator, so that export embeds that one and not the other."""

    def __init__(self, model, a2b: bool):
        super().__init__()
        self.gen = model.gen("AB" if a2b else "BA")
        self.model = model
        self.a2b = a2b

    def forward(self, x_u8: torch.Tensor, z: torch.Tensor):
        # model code is imported to export only; serving an artifact needs none
        from aclgan_tpu_torch.serving import translate_u8

        img, mask = translate_u8(self.model, x_u8, z, self.a2b)
        out = {"image": img}
        if mask is not None:
            out["mask"] = mask.float()
        return out


def export_translator(
    config,
    checkpoint: str,
    a2b: bool = True,
    batch_size: int = 32,
    size: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
):
    """Trace a generator checkpoint (`.pt` or `.msgpack`) into an
    `ExportedProgram` of the translation step on `device`, weights embedded.
    Returns (exported_program, meta_dict)."""
    from aclgan_tpu_torch.config import load_config
    from aclgan_tpu_torch.trainer import ACLGAN
    from aclgan_tpu_torch.utils.checkpoint import load_generators

    cfg = load_config(config) if isinstance(config, str) else config
    size_a, size_b = cfg.data.resolved_sizes()
    size = size or (size_a if a2b else size_b) or 256
    stride = 2 ** cfg.gen.n_downsample
    if size % stride:
        raise ValueError(f"size {size} must be a multiple of the generator "
                         f"stride {stride} (2**n_downsample)")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")

    model = ACLGAN(cfg, device=device)
    load_generators(checkpoint, model)
    step = _TranslateStep(model, a2b).eval()
    x = torch.zeros((batch_size, size, size, 3), dtype=torch.uint8, device=model.device)
    z = torch.zeros((batch_size, cfg.gen.style_dim), dtype=torch.float32,
                    device=model.device)
    with torch.no_grad():
        exported = torch.export.export(step, (x, z))
    meta = {
        "format": _FORMAT,
        "batch_size": batch_size,
        "size": size,
        "a2b": bool(a2b),
        "style_dim": int(cfg.gen.style_dim),
        "focus": bool(model.use_focus),
        "torch_version": torch.__version__,
        "device": str(model.device),
    }
    return exported, meta


def kernel_nodes(exported) -> int:
    """How many `aclgan::` op nodes (K1 launches per call) the graph holds."""
    return sum(node.op == "call_function" and str(node.target).startswith("aclgan.")
               for node in exported.graph.nodes)


def save_artifact(exported, meta: dict, path: str) -> None:
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    header = json.dumps(meta).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(buf.getvalue())


def load_artifact(path: str):
    """-> (ExportedProgram on the device it was traced on, meta)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an aclgan_tpu_torch export artifact "
                             f"(bad magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(hlen).decode("utf-8"))
        if meta.get("format") != _FORMAT:
            raise ValueError(f"{path}: unsupported artifact format "
                             f"{meta.get('format')!r}")
        payload = f.read()
    return torch.export.load(io.BytesIO(payload)), meta


class ExportedTranslator:
    """Serve an exported artifact with the `serving.Translator` list API
    (shortest-side resize + center crop, tail-batch padding, per-image
    styles, `return_masks`), loading no model code: the graph and weights
    come from the artifact. Runs on CUDA unless `device="cpu"`."""

    def __init__(self, path: str, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                               "on the CPU")
        exported, self.meta = load_artifact(path)
        if torch.device(self.meta["device"]) != dev:
            from torch.export.passes import move_to_device_pass

            exported = move_to_device_pass(exported, dev)
        self.exported = exported
        self.program = exported.module()
        self.device = dev
        self.batch_size = int(self.meta["batch_size"])
        self.size = int(self.meta["size"])
        self.style_dim = int(self.meta["style_dim"])
        self._rng = torch.Generator().manual_seed(seed)
        self._rng_lock = threading.Lock()

    def random_style(self, n: int = 1) -> np.ndarray:
        """Draw n style codes from the serving RNG stream (thread-safe)."""
        with self._rng_lock:
            return torch.randn((n, self.style_dim), generator=self._rng).numpy()

    def __call__(
        self,
        images: Sequence[np.ndarray],
        styles: Optional[np.ndarray] = None,
        return_masks: bool = False,
    ) -> Union[List[np.ndarray], Tuple[List[np.ndarray], Optional[list]]]:
        n = len(images)
        if n == 0:
            return ([], None) if return_masks else []
        prepped = np.stack([prep_image(im, self.size) for im in images])
        if styles is None:
            styles = self.random_style(n)
        styles = np.asarray(styles, np.float32)
        if styles.ndim == 1:
            styles = np.broadcast_to(styles[None], (n, styles.shape[0]))

        outs: List[np.ndarray] = []
        masks: list = []
        bs = self.batch_size
        for start in range(0, n, bs):
            chunk = prepped[start:start + bs]
            zc = styles[start:start + bs]
            keep = chunk.shape[0]
            if keep < bs:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - keep, 0)])
                zc = np.concatenate([zc, np.repeat(zc[-1:], bs - keep, 0)])
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            z = torch.from_numpy(np.ascontiguousarray(zc)).to(self.device)
            with torch.inference_mode():
                out = self.program(x, z)
            outs.extend(list(out["image"][:keep].cpu().numpy()))
            if "mask" in out:
                masks.extend(list(out["mask"][:keep].cpu().numpy()))
        if return_masks:
            return outs, (masks if masks else None)
        return outs
