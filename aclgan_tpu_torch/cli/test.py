"""Single-image translation CLI — `python -m aclgan_tpu_torch.cli.test`.

    python -m aclgan_tpu_torch.cli.test --config <yaml> --input img.jpg \
        --output_folder out/ --checkpoint gen_00020000.pt [--style s.jpg] \
        [--a2b 1] [--seed 10] [--num_style 10] [--output_only] [--device cuda]

Port of `aclgan_tpu/cli/test.py`. The input's shortest side is resized to
the config's size (no crop), reflect-padded to a multiple of the generator
stride (2**n_downsample) and cropped back after the decode. The content is
encoded once and decoded with all `num_style` styles as one batch, then
blended over the input with the eval blend. `--style` encodes one style
image instead. Writes `outputNNN.jpg`, and with focus masks `outputNNN_mask.jpg`
and `outputNNN_img.jpg` (the unblended decode), and `input.jpg` unless
`--output_only`. The checkpoint is the port's `.pt` or the JAX package's
`.msgpack`.

Random styles come from a `torch.Generator` seeded with `--seed`; they cannot
equal the JAX CLI's `jax.random.normal` draws, so the two CLIs agree only
with `--style` or injected styles (`translate_styles`).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from aclgan_tpu_torch import losses
from aclgan_tpu_torch.config import load_config
from aclgan_tpu_torch.data.dataset import load_image
from aclgan_tpu_torch.data.transforms import normalize_batch, resize_shortest
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import load_generators
from aclgan_tpu_torch.utils.image import save_image


def load_input(path: str, size: Optional[int], stride: int) -> Tuple[np.ndarray, int, int]:
    """An image file -> ((1, H, W, 3) float32 in [-1, 1], h0, w0): shortest
    side resized to `size`, reflect-padded to a multiple of `stride`; (h0, w0)
    is the size before the pad."""
    arr = np.asarray(resize_shortest(load_image(path), size), np.uint8)
    h0, w0 = arr.shape[:2]
    ph, pw = (-h0) % stride, (-w0) % stride
    if ph or pw:
        arr = np.pad(arr, ((0, ph), (0, pw), (0, 0)), mode="reflect")
    return normalize_batch(arr[None]), h0, w0


@torch.no_grad()
def translate_styles(model: ACLGAN, x, styles, a2b: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """One image (1, H, W, 3) in [-1, 1] with S styles (S, style_dim): the
    content encoded once, repeated S times and decoded as one batch.
    Returns NHWC float32 numpy (eval-blended image, raw decode, mask or None)."""
    gen = model.gen_AB if a2b else model.gen_BA
    xs = model._images(x).to(model.dtype)
    styles = torch.as_tensor(styles).to(model.device, model.dtype)
    n = styles.shape[0]
    content = gen.encode_content(xs).repeat(n, 1, 1, 1)
    raw, mask = model._split_img_mask(gen.decode(content, styles))
    out = raw
    if mask is not None:
        out = losses.focus_translation_eval(raw, xs.repeat(n, 1, 1, 1).to(raw.dtype), mask)

    def host(t):
        return None if t is None else t.permute(0, 2, 3, 1).float().cpu().numpy()

    return host(out), host(raw), host(mask)


def write_outputs(folder: str, outputs: np.ndarray, raw: np.ndarray,
                  masks: Optional[np.ndarray], x: Optional[np.ndarray]) -> None:
    """The JAX CLI's files: outputNNN.jpg (+ _mask, _img), input.jpg if x."""
    for j in range(outputs.shape[0]):
        save_image((outputs[j:j + 1] + 1.0) / 2.0,
                   os.path.join(folder, f"output{j:03d}.jpg"), nrow=1, normalize=True)
        if masks is not None:
            save_image(np.repeat(masks[j:j + 1], 3, axis=-1),
                       os.path.join(folder, f"output{j:03d}_mask.jpg"), nrow=1,
                       normalize=True)
            save_image(raw[j:j + 1], os.path.join(folder, f"output{j:03d}_img.jpg"),
                       nrow=1, normalize=True)
    if x is not None:
        save_image(x, os.path.join(folder, "input.jpg"), nrow=1, normalize=True)


def main(argv=None) -> Dict[str, Optional[np.ndarray]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, help="net configuration")
    parser.add_argument("--input", type=str, help="input image path")
    parser.add_argument("--output_folder", type=str, help="output image path")
    parser.add_argument("--checkpoint", type=str, help="checkpoint of autoencoders")
    parser.add_argument("--style", type=str, default="", help="style image path")
    parser.add_argument("--a2b", type=int, default=1, help="1 for a2b and 0 for b2a")
    parser.add_argument("--seed", type=int, default=10, help="random seed")
    parser.add_argument("--num_style", type=int, default=10,
                        help="number of styles to sample")
    parser.add_argument("--synchronized", action="store_true")
    parser.add_argument("--output_only", action="store_true")
    parser.add_argument("--output_path", type=str, default=".")
    parser.add_argument("--trainer", type=str, default="aclgan")
    parser.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    opts = parser.parse_args(argv)

    if opts.trainer != "aclgan":
        sys.exit("Only support aclgan")

    cfg = load_config(opts.config)
    os.makedirs(opts.output_folder, exist_ok=True)
    model = ACLGAN(cfg, device=opts.device)
    load_generators(opts.checkpoint, model)

    size_a, size_b = cfg.data.resolved_sizes()
    new_size = size_a if opts.a2b else size_b
    x, h0, w0 = load_input(opts.input, new_size, 2 ** cfg.gen.n_downsample)
    if opts.style:
        s_x = normalize_batch(np.asarray(resize_shortest(load_image(opts.style), new_size),
                                         np.uint8)[None])
        gen = model.gen_AB if opts.a2b else model.gen_BA
        with torch.no_grad():
            styles = gen.encode_style(model._images(s_x).to(model.dtype)).float()
    else:
        gen = torch.Generator().manual_seed(opts.seed)
        styles = torch.randn((opts.num_style, cfg.gen.style_dim), generator=gen)

    outputs, raw, masks = translate_styles(model, x, styles, bool(opts.a2b))
    outputs, raw = outputs[:, :h0, :w0], raw[:, :h0, :w0]
    masks = None if masks is None else masks[:, :h0, :w0]
    x = x[:, :h0, :w0]
    write_outputs(opts.output_folder, outputs, raw, masks, None if opts.output_only else x)
    print(f"Wrote {outputs.shape[0]} style outputs to {opts.output_folder}")
    return {"outputs": outputs, "raw": raw, "masks": masks,
            "styles": styles.cpu().numpy()}


if __name__ == "__main__":
    main()
