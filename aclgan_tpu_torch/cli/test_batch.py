"""Batch translation with IS / CIS / FID — `python -m aclgan_tpu_torch.cli.test_batch`.

    python -m aclgan_tpu_torch.cli.test_batch --config <yaml> \
        --input_folder testA/ --output_folder out/ --checkpoint gen_00020000.pt \
        [--num_style 3] [--synchronized] [--batch 8] [--compute_IS] [--compute_CIS] \
        [--compute_FID --fid_real_folder testB/] [--inception_weights inc.pt] \
        [--device cuda]

Port of `aclgan_tpu/cli/test_batch.py`. For every input image (at most
`--max_images`, resized and center-cropped to the config's size) and every
style triple j, `translate_triplet` computes
  bar = Dab(Gab(x))   the translation, saved to `_NN_bar/` (+ `_NN_mask/`),
  hat = Dba(Gba(bar)) the cycle back,
  til = Dba(Gba(x))   the in-domain translation,
each with the eval blend (hat and til saved to `_NN_hat/`, `_NN_til/` with
`--save_all`), and `inputNNN.jpg` unless `--output_only`. Styles are drawn at
2x scale; `--synchronized` uses one fixed set of triples for every batch,
otherwise every batch's triples are drawn up front. Batches come from the
loader's `iter_padded`: the tail batch is padded and its outputs sliced to
the valid images.

Scores: IS over the softmax of all translations with their overall prior,
CIS per input over its own styles (scipy `entropy`), the target-domain rate
for a 2-class classifier, and FID of the style-0 translations against
`--fid_real_folder` (checked before the loop). `main` returns them.

Styles come from a `torch.Generator` seeded with `--seed`; they cannot equal
the JAX CLI's `jax.random` draws, so the two CLIs agree only on injected
styles (`translate_triplet`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
from scipy.stats import entropy

from aclgan_tpu_torch import losses
from aclgan_tpu_torch.config import load_config
from aclgan_tpu_torch.data.dataset import list_images_folder
from aclgan_tpu_torch.data.loader import DataLoader, ImageDataset
from aclgan_tpu_torch.data.transforms import TransformSpec
from aclgan_tpu_torch.eval.fid import feature_stats, frechet_distance
from aclgan_tpu_torch.eval.inception import InceptionScorer
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import load_generators
from aclgan_tpu_torch.utils.image import save_image


@torch.no_grad()
def translate_triplet(model: ACLGAN, x, s1, s2, s3, a2b: bool = True):
    """bar / bar mask / hat / til for one style triple, batched over the
    images x (NHWC, uint8 or [-1, 1]); each style (style_dim,) is shared by
    the batch. Returns NHWC tensors in the compute dtype (mask None without
    focus masks)."""
    g_ab = model.gen_AB if a2b else model.gen_BA
    g_ba = model.gen_BA
    x = model._images(x).to(model.dtype)
    n = x.shape[0]

    def dec(gen, content, s):
        s = torch.as_tensor(s).to(model.device, model.dtype).reshape(1, -1).expand(n, -1)
        return model._split_img_mask(gen.decode(content, s))

    def blend(raw, bg, mask):
        return raw if mask is None else losses.focus_translation_eval(raw, bg, mask)

    c_ab = g_ab.encode_content(x)    # Gab
    c_til = g_ba.encode_content(x)   # Gba
    bar_raw, bar_mask = dec(g_ab, c_ab, s1)
    bar = blend(bar_raw, x, bar_mask)
    hat_raw, hat_mask = dec(g_ba, g_ba.encode_content(bar), s2)
    hat = blend(hat_raw, bar, hat_mask)
    til_raw, til_mask = dec(g_ba, c_til, s3)
    til = blend(til_raw, x, til_mask)
    nhwc = [None if t is None else t.permute(0, 2, 3, 1) for t in (bar, bar_mask, hat, til)]
    return tuple(nhwc)


def draw_styles(seed: int, num_style: int, style_dim: int, n_batches: int,
                synchronized: bool) -> np.ndarray:
    """(n_batches, num_style, 3, style_dim) style triples at 2x scale: one
    fixed set repeated for every batch when synchronized."""
    gen = torch.Generator().manual_seed(seed)
    fixed = 2.0 * torch.randn((num_style, 3, style_dim), generator=gen)
    if synchronized:
        return fixed.expand(n_batches, -1, -1, -1).numpy()
    return (2.0 * torch.randn((n_batches, num_style, 3, style_dim), generator=gen)).numpy()


def inception_score(preds: np.ndarray) -> float:
    """exp(mean KL(p(y|x) || p(y))), the prior summed over all outputs."""
    py = preds.sum(axis=0)
    return float(np.exp(np.mean([entropy(p, py) for p in preds])))


def conditional_kl(cur: np.ndarray) -> list:
    """KL of each style's prediction from its input's prior over its own
    styles; cur is (num_style, B, classes)."""
    out = []
    for bi in range(cur.shape[1]):
        py = cur[:, bi].sum(axis=0)
        out += [entropy(cur[js, bi], py) for js in range(cur.shape[0])]
    return out


def _save(img01: np.ndarray, path: str) -> None:
    save_image(img01[None], path, nrow=1, normalize=True)


def main(argv=None) -> Dict[str, Optional[float]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, help="Path to the config file.")
    parser.add_argument("--input_folder", type=str, help="input image folder")
    parser.add_argument("--output_folder", type=str, help="output image folder")
    parser.add_argument("--checkpoint", type=str, help="checkpoint of autoencoders")
    parser.add_argument("--a2b", type=int, default=1)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--num_style", type=int, default=1)
    parser.add_argument("--synchronized", action="store_true")
    parser.add_argument("--output_only", action="store_true")
    parser.add_argument("--output_path", type=str, default=".")
    parser.add_argument("--trainer", type=str, default="aclgan")
    parser.add_argument("--compute_IS", action="store_true")
    parser.add_argument("--compute_CIS", action="store_true")
    parser.add_argument("--compute_FID", action="store_true",
                        help="FID of translated outputs vs --fid_real_folder")
    parser.add_argument("--fid_real_folder", type=str, default=None,
                        help="folder of real target-domain images for FID")
    parser.add_argument("--inception_a", type=str, default=".")
    parser.add_argument("--inception_b", type=str, default=".")
    parser.add_argument("--inception_weights", type=str, default=None,
                        help="inception weights for FID features (.pt or .msgpack)")
    parser.add_argument("--batch", type=int, default=8, help="device batch")
    parser.add_argument("--save_all", action="store_true",
                        help="also save hat and til")
    parser.add_argument("--max_images", type=int, default=3000)
    parser.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    opts = parser.parse_args(argv)

    if opts.trainer != "aclgan":
        sys.exit("Only support aclgan")

    cfg = load_config(opts.config)
    model = ACLGAN(cfg, device=opts.device)
    load_generators(opts.checkpoint, model)

    inception = None
    if opts.compute_IS or opts.compute_CIS:
        ckpt = opts.inception_b if opts.a2b else opts.inception_a
        if ckpt in (".", "", None) and opts.inception_weights:
            ckpt = opts.inception_weights  # one fine-tuned classifier for all
        inception = InceptionScorer(ckpt, device=model.device)
        if not inception.pretrained:
            print("WARNING: IS/CIS with a randomly-initialized inception classifier (no "
                  "loadable --inception_a/b weights) — the printed scores are "
                  "numerically meaningless")
    fid_scorer = None
    fake_feats = []
    if opts.compute_FID:
        if not opts.fid_real_folder:
            # checked before the (potentially hours-long) translation loop
            sys.exit("--compute_FID requires --fid_real_folder")
        fid_scorer = InceptionScorer(opts.inception_weights, device=model.device)
        if not fid_scorer.pretrained:
            print("WARNING: FID with randomly-initialized inception features (no "
                  "--inception_weights given) — relative values only")

    if opts.batch < 1:
        sys.exit("--batch must be >= 1")
    size_a, size_b = cfg.data.resolved_sizes()
    new_size = size_a if opts.a2b else size_b
    if new_size is None:
        sys.exit("config must set new_size (or new_size_a/new_size_b for this "
                 "direction) for batched translation")
    paths = list_images_folder(opts.input_folder)[:opts.max_images]
    if not paths:
        sys.exit(f"no images found in --input_folder {opts.input_folder}")
    # resize shortest side, center-crop to square so batching is possible
    spec = TransformSpec(new_size=new_size, crop_h=new_size, crop_w=new_size, flip=False)
    batch = min(opts.batch, len(paths))
    loader = DataLoader(ImageDataset(paths, spec), batch_size=batch, train=False,
                        num_workers=4, seed=opts.seed)
    n_batches = -(-len(paths) // batch)
    styles = draw_styles(opts.seed, opts.num_style, cfg.gen.style_dim, n_batches,
                         opts.synchronized)

    a2b = bool(opts.a2b)
    all_preds, cis = [], []
    img_idx = 0
    for batch_idx, (x, n_valid) in enumerate(loader.iter_padded()):
        names = [os.path.basename(p) for p in paths[img_idx:img_idx + n_valid]]
        cur_preds = []
        for j in range(opts.num_style):
            s1, s2, s3 = styles[batch_idx, j]
            bar, bar_mask, hat, til = translate_triplet(model, x, s1, s2, s3, a2b)
            bar01 = (bar.float().cpu().numpy() + 1.0) / 2.0
            if fid_scorer is not None and j == 0:
                fake_feats.append(fid_scorer.features(bar01)[:n_valid])
            if inception is not None:
                pred = inception.predict(bar01)[:n_valid]  # (B, classes) softmax
                if opts.compute_IS:
                    all_preds.append(pred)
                if opts.compute_CIS:
                    cur_preds.append(pred)
            mask = None if bar_mask is None else bar_mask.float().cpu().numpy()
            extra = {}
            if opts.save_all:
                extra = {"hat": (hat.float().cpu().numpy() + 1) / 2,
                         "til": (til.float().cpu().numpy() + 1) / 2}
            for bi, name in enumerate(names):
                _save(bar01[bi], os.path.join(opts.output_folder, f"_{j:02d}_bar", name))
                if mask is not None:
                    _save(np.repeat(mask[bi], 3, -1),
                          os.path.join(opts.output_folder, f"_{j:02d}_mask", name))
                for kind, imgs in extra.items():
                    _save(imgs[bi], os.path.join(opts.output_folder, f"_{j:02d}_{kind}",
                                                 name))
        if opts.compute_CIS and cur_preds:
            cis += conditional_kl(np.stack(cur_preds, 0))
        if not opts.output_only:
            for bi in range(n_valid):
                _save(x[bi], os.path.join(opts.output_folder, f"input{img_idx + bi:03d}.jpg"))
        img_idx += n_valid
        print(f"{img_idx}/{len(paths)}")

    result: Dict[str, Optional[float]] = {"IS": None, "CIS": None, "FID": None,
                                          "target_domain_rate": None,
                                          "fid_seconds": None, "n_images": img_idx}
    if opts.compute_IS and all_preds:
        preds = np.concatenate(all_preds, 0)
        result["IS"] = inception_score(preds)
        print("Inception Score: {}".format(result["IS"]))
        if preds.shape[1] == 2:
            # two-domain classifier: with a saturated one, IS degenerates to
            # 1.0 exactly when this rate is 0 or 1
            rate = float(np.mean(np.argmax(preds, -1) == (1 if a2b else 0)))
            result["target_domain_rate"] = rate
            print(f"Target-domain classification rate: {rate:.4f}")
    if opts.compute_CIS and cis:
        result["CIS"] = float(np.exp(np.mean(cis)))
        print("conditional Inception Score: {}".format(result["CIS"]))
    if fid_scorer is not None:  # --fid_real_folder checked at startup
        real_paths = list_images_folder(opts.fid_real_folder)[:opts.max_images]
        real_loader = DataLoader(ImageDataset(real_paths, spec),
                                 batch_size=min(opts.batch, len(real_paths)),
                                 train=False, num_workers=4, seed=opts.seed)
        real_feats = [fid_scorer.features((b + 1.0) / 2.0)[:n]
                      for b, n in real_loader.iter_padded()]
        t0 = time.perf_counter()
        result["FID"] = frechet_distance(*feature_stats(np.concatenate(real_feats, 0)),
                                         *feature_stats(np.concatenate(fake_feats, 0)))
        result["fid_seconds"] = time.perf_counter() - t0
        print("FID: {:.4f}".format(result["FID"]))
    return result


if __name__ == "__main__":
    main()
