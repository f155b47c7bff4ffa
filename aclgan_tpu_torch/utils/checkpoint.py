"""Generator checkpoints in the reference's `.pt` layout.

`gen_%08d.pt` holds `{'AB': state_dict, 'BA': state_dict}` with reference key
names, so the JAX package's `import_torch_gen_checkpoint` (and its Translator
and CLIs) load a port snapshot unchanged. Reading the JAX package's msgpack
snapshots is not ported yet.
"""

from __future__ import annotations

import os

import torch


def save_generators(path: str, model) -> None:
    """Write `model.gen_AB` / `model.gen_BA` to `path` atomically."""
    ckpt = {k: {name: t.detach().cpu().contiguous() for name, t in g.state_dict().items()}
            for k, g in (("AB", model.gen_AB), ("BA", model.gen_BA))}
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def load_generators(path: str, model) -> None:
    """Load a `{'AB', 'BA'}` `.pt` checkpoint into `model`'s generators."""
    if not path.endswith((".pt", ".pth")):
        raise ValueError(f"{path}: the port reads .pt generator checkpoints only")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.gen_AB.load_state_dict(ckpt["AB"])
    model.gen_BA.load_state_dict(ckpt["BA"])
