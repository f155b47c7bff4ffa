"""Fine-tune InceptionV3 as a two-domain classifier for IS / CIS / FID.

    python -m aclgan_tpu_torch.cli.train_inception --data_root ds/ \
        --out inception.pt [--steps 300] [--batch 32] [--lr 2e-4] [--size 149] \
        [--seed 0] [--device cuda]

Port of `tools/train_inception.py`. IS and CIS score translations with an
inception model fine-tuned on the two domains: this trains
`InceptionV3(num_classes=2)` to tell trainA (label 0) from trainB (label 1)
and writes a torchvision-layout state_dict `.pt`, which `cli.test_batch
--inception_weights` and `cli.fid_curve` take, and which the JAX package's
`InceptionScorer` reads as well. Images load at `--size` (149 = 299/2);
batches are drawn without replacement from a seeded `np.random.RandomState`;
Adam (betas 0.9/0.999, eps 1e-8, optax's defaults) on the softmax cross
entropy. BatchNorm stays in eval mode at its identity statistics (its scale
and shift train), so training and scoring see the same network; float32
throughout (`full_f32`).

One seed and one dataset give one weight set, on a card as on the CPU (at a
fixed thread count), as the JAX tool's does: the training loop runs under
`deterministic()`, which puts cuDNN and every other op on a deterministic
algorithm and restores the caller's settings after it.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import time
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aclgan_tpu_torch.data.dataset import load_image
from aclgan_tpu_torch.eval.inception import InceptionV3, full_f32
from aclgan_tpu_torch.trainer import resolve_device


CUBLAS_WORKSPACE = "CUBLAS_WORKSPACE_CONFIG"
CUBLAS_DETERMINISTIC = ":4096:8"  # a fixed cuBLAS workspace: one reduction order a product


@contextlib.contextmanager
def deterministic() -> Iterator[None]:
    """Deterministic algorithms inside the block: cuDNN's (no benchmark
    search), every op's (`torch.use_deterministic_algorithms`, which raises
    on an op that has none), and cuBLAS's workspace setting, which that check
    reads from the environment at each product. The settings are the
    process's, so the caller's come back on the way out."""
    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark, torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            os.environ.get(CUBLAS_WORKSPACE))
    os.environ[CUBLAS_WORKSPACE] = CUBLAS_DETERMINISTIC
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev[0], prev[1]
        torch.use_deterministic_algorithms(prev[2], warn_only=prev[3])
        if prev[4] is None:
            os.environ.pop(CUBLAS_WORKSPACE, None)
        else:
            os.environ[CUBLAS_WORKSPACE] = prev[4]


def weights_digest(state: Dict[str, torch.Tensor]) -> str:
    """sha256 of a state_dict: each entry's name, dtype, shape and bytes, in
    key order (a `.pt` file's own bytes also hold its file name)."""
    h = hashlib.sha256()
    for k in sorted(state):
        t = state[k].detach().cpu().contiguous()
        h.update(f"{k} {t.dtype} {tuple(t.shape)}\n".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def load_folder(folder: str, size: int = 149) -> np.ndarray:
    """All images in a folder as (N, size, size, 3) float32 in [0, 1]."""
    from PIL import Image

    out = []
    for f in sorted(os.listdir(folder)):
        if not f.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        im = load_image(os.path.join(folder, f)).resize((size, size), Image.BILINEAR)
        out.append(np.asarray(im, np.float32) / 255.0)
    return np.stack(out)


def make_optimizer(model: InceptionV3, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(model: InceptionV3, opt: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Adam step on NHWC [0, 1] images x and int labels y; returns the
    (loss, accuracy) of the batch before the step, as 0-dim tensors."""
    with full_f32():
        logits = model(x.permute(0, 3, 1, 2))
        # softmax cross entropy through a gather: NLLLoss has no deterministic
        # CUDA path, and raises under `deterministic()`
        loss = -F.log_softmax(logits, -1).gather(1, y[:, None]).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
    opt.step()
    acc = (logits.argmax(-1) == y).float().mean()
    return loss.detach(), acc


@torch.no_grad()
def accuracy(model: InceptionV3, x: torch.Tensor, y: torch.Tensor, chunk: int = 64) -> float:
    with full_f32():
        pred = torch.cat([model(x[s:s + chunk].permute(0, 3, 1, 2)).argmax(-1)
                          for s in range(0, len(x), chunk)])
    return float((pred == y).float().mean())


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", required=True, help="folder with trainA/ and trainB/")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--size", type=int, default=149)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    xa = load_folder(os.path.join(args.data_root, "trainA"), args.size)
    xb = load_folder(os.path.join(args.data_root, "trainB"), args.size)
    x = torch.from_numpy(np.concatenate([xa, xb])).to(device)
    y = torch.cat([torch.zeros(len(xa), dtype=torch.long),
                   torch.ones(len(xb), dtype=torch.long)]).to(device)
    print(f"train set: {len(xa)} A + {len(xb)} B images at {args.size}px")

    model = InceptionV3(num_classes=2, gen=torch.Generator().manual_seed(args.seed))
    model.to(device).eval()
    opt = make_optimizer(model, args.lr)
    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    with deterministic():
        for i in range(args.steps):
            idx = torch.from_numpy(rng.choice(len(x), args.batch, replace=False)).to(device)
            loss, acc = train_step(model, opt, x[idx], y[idx])
            if (i + 1) % 25 == 0 or i == 0:
                print(f"step {i + 1}/{args.steps}: loss={float(loss):.4f} "
                      f"acc={float(acc):.3f} ({time.time() - t0:.1f}s)")
        if device.type == "cuda":
            torch.cuda.synchronize()
    train_s = time.time() - t0

    full_acc = accuracy(model, x, y)
    print(f"full-set accuracy: {full_acc:.4f}")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(state, args.out)
    digest = weights_digest(state)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB), weights sha256 "
          f"{digest}")
    return {"loss": float(loss), "accuracy": full_acc, "train_seconds": train_s,
            "steps_per_second": args.steps / train_s, "weights_sha256": digest}


if __name__ == "__main__":
    main()
