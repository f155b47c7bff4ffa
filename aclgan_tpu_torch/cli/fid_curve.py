"""FID / target-domain-rate curve across a run's snapshots.

    python -m aclgan_tpu_torch.cli.fid_curve --config <yaml> \
        --run_dir outputs/<name> --inception_weights inception.pt [--n 500] \
        [--styles 3] [--bootstrap 100] [--prefix gen|ema] [--start_after N] \
        [--device cuda]

Port of `tools/fid_curve.py`. GAN FID is not monotonic in training time, so
quality is reported as a curve over the run's retained snapshots, and the
best snapshot is picked from it. One process loads the model and the scorer
once, computes the real-side statistics once (testB for A->B), then for every
`<prefix>_%08d` snapshot in `<run_dir>/checkpoints` (the port's `.pt` or the
JAX package's `.msgpack`) translates the first `--n` source images with each
of `--styles` synchronized styles at 2x scale (`ACLGAN.translate`, eval
blend), and reports the mean of the per-style float64 scipy FIDs and the
target-domain rate of a 2-class scorer. Each style's FID (a 2048^2 `sqrtm`
on the host, which releases the GIL) runs on a thread of its own while the
card translates and scores the next style.

`--bootstrap B` adds a 95% CI: each resample redraws every style's fake
features with replacement and averages the per-style FIDs, in float32 on the
device through tr sqrtm(S1 S2) = sum sqrt eig(sqrt(S1) S2 sqrt(S1))
(`FidBootstrap`, which takes that spectrum from an n x n Gram matrix when
there are fewer images than features). The interval is a recentred (basic) bootstrap around the
float32 point of the same formulation, shifted to the float64 point FID, so
the float32 error shared by anchor and resamples cancels; their difference
is kept per row as `fid_f32_minus_f64`. The lower bound is clipped at 0.

Writes `<run_dir>/fid_curve_<prefix>.json` after every row (the JAX tool's
keys) and prints a markdown table. `--start_after N` skips snapshots up to
iteration N and keeps the rows already in that file, if the earlier run used
the same protocol and flags. Styles come from a `torch.Generator` seeded with
`--seed`; they cannot equal the JAX tool's `jax.random` draws.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import numpy as np
import torch

from aclgan_tpu_torch.config import load_config
from aclgan_tpu_torch.data.dataset import list_images_folder
from aclgan_tpu_torch.data.loader import DataLoader, ImageDataset
from aclgan_tpu_torch.data.transforms import TransformSpec
from aclgan_tpu_torch.eval.fid import feature_stats, frechet_distance
from aclgan_tpu_torch.eval.inception import InceptionScorer
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import list_snapshots, load_generators, parse_iteration

PROTOCOL = "synchronized 2x style, eval blend, pool3 FID"
CI_METHOD = "per-style resample, recentered basic bootstrap, f32-eigh anchored to f64 point"
BATCH = 128   # --batch's default
SEED = 1      # --seed's default


def image_batches(cfg, paths, a2b: bool = True, batch: int = BATCH, seed: int = SEED):
    """(batch, valid rows) of `paths` as the sweep loads both of its sides:
    resized square to the source domain's size, unflipped, in order."""
    size_a, size_b = cfg.data.resolved_sizes()
    new_size = size_a if a2b else size_b
    spec = TransformSpec(new_size=new_size, crop_h=new_size, crop_w=new_size, flip=False)
    loader = DataLoader(ImageDataset(paths, spec), batch_size=min(batch, len(paths)),
                        train=False, num_workers=2, seed=seed)
    return loader.iter_padded()


def pool3_features(scorer, batches) -> np.ndarray:
    """The scorer's pool3 features of the valid rows of `batches`."""
    return np.concatenate([scorer.features((b + 1.0) / 2.0)[:n] for b, n in batches], 0)


class FidBootstrap:
    """float32 FIDs against fixed real statistics, on `device`:
    ||mu_r - mu_f||^2 + tr S_r + tr S_f - 2 sum sqrt eig(sqrt(S_r) S_f sqrt(S_r)).
    sqrt(S_r) is computed once, in float64 on the host. With S_f = X^T X
    (X the centred fakes over sqrt(n - 1)) those eigenvalues are B^T B's,
    B = X sqrt(S_r), and the nonzero ones are B B^T's: the solver takes the
    smaller of the two (n x n when n < D). On the D x D product, float32
    `eigvalsh` fails to converge for a briefly fine-tuned classifier's
    features ("too many repeated eigenvalues": most are zero)."""

    def __init__(self, mu_r: np.ndarray, sig_r: np.ndarray, device: torch.device):
        ev, vec = np.linalg.eigh(sig_r.astype(np.float64))
        sqrt_sr = (vec * np.sqrt(np.clip(ev, 0.0, None))) @ vec.T
        self.sqrt_sr = torch.as_tensor(sqrt_sr, dtype=torch.float32, device=device)
        self.mu_r = torch.as_tensor(mu_r, dtype=torch.float32, device=device)
        self.tr_sr = float(np.trace(sig_r))

    def fid32(self, feats: torch.Tensor) -> torch.Tensor:
        """(K, n, D) features -> the K float32 FIDs."""
        n, dim = feats.shape[1:]
        mu_f = feats.mean(1)
        xc = (feats - mu_f[:, None]) / math.sqrt(n - 1)
        b = xc @ self.sqrt_sr
        gram = b @ b.transpose(1, 2) if n < dim else b.transpose(1, 2) @ b
        ev = torch.linalg.eigvalsh(gram).clamp_min(0.0)
        d = self.mu_r - mu_f
        return ((d * d).sum(-1) + self.tr_sr + (xc * xc).sum((1, 2))
                - 2.0 * ev.sqrt().sum(-1))

    def point(self, feats: torch.Tensor) -> float:
        """The mean over styles of the float32 FIDs (the anchor)."""
        return float(self.fid32(feats).mean())

    def resample(self, feats: torch.Tensor, gen: torch.Generator) -> float:
        """One bootstrap draw of the style-mean FID: each style's features
        redrawn with replacement."""
        k, n = feats.shape[:2]
        idx = torch.randint(0, n, (k, n), generator=gen).to(feats.device)
        return float(self.fid32(feats[torch.arange(k, device=feats.device)[:, None], idx])
                     .mean())


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--run_dir", required=True,
                   help="outputs/<name> dir containing checkpoints/")
    p.add_argument("--inception_weights", required=True)
    p.add_argument("--n", type=int, default=500, help="images per side")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--a2b", type=int, default=1)
    p.add_argument("--prefix", default="gen", choices=("gen", "ema"),
                   help="snapshot family to sweep: live weights (gen_*) or EMA "
                        "weights (ema_*, tpu.ema_decay runs)")
    p.add_argument("--styles", type=int, default=1,
                   help="style draws per snapshot; >1 reports per-style FIDs + spread")
    p.add_argument("--bootstrap", type=int, default=0,
                   help="bootstrap resamples of the fake features for a 95%% CI")
    p.add_argument("--start_after", type=int, default=0,
                   help="skip snapshots with iteration <= this and keep the rows "
                        "already in the output file")
    p.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    model = ACLGAN(cfg, device=args.device)
    a2b = bool(args.a2b)
    scorer = InceptionScorer(args.inception_weights, device=model.device)
    if not scorer.pretrained:
        sys.exit("--inception_weights must name fine-tuned inception weights")

    src = os.path.join(cfg.data.data_root, "testA" if a2b else "testB")
    dst = os.path.join(cfg.data.data_root, "testB" if a2b else "testA")
    src_paths = list_images_folder(src)[:args.n]
    dst_paths = list_images_folder(dst)[:args.n]
    print(f"{len(src_paths)} source / {len(dst_paths)} real target images")

    def batches(paths):
        return image_batches(cfg, paths, a2b, args.batch, args.seed)

    real_feats = pool3_features(scorer, batches(dst_paths))
    mu_r, sig_r = feature_stats(real_feats)
    n_real = len(real_feats)

    sd = cfg.gen.style_dim
    styles = 2.0 * torch.randn((max(1, args.styles), sd),
                               generator=torch.Generator().manual_seed(args.seed))
    boot = FidBootstrap(mu_r, sig_r, model.device) if args.bootstrap else None

    ckpt_dir = os.path.join(args.run_dir, "checkpoints")
    snaps = [s for s in list_snapshots(ckpt_dir, args.prefix)
             if parse_iteration(s) > args.start_after]
    if not snaps:
        sys.exit(f"no {args.prefix} snapshots under {ckpt_dir}")

    # merge the rows of an interrupted sweep only under the same protocol and
    # flags: FID is strongly n-biased, so mixed rows would corrupt `best`
    meta = {"n": args.n, "styles": len(styles), "bootstrap": args.bootstrap,
            "prefix": args.prefix, "protocol": PROTOCOL,
            "ci": CI_METHOD if args.bootstrap else None}
    out_path = os.path.join(args.run_dir, f"fid_curve_{args.prefix}.json")
    rows = []
    if args.start_after and os.path.exists(out_path):
        with open(out_path) as f:
            prior_doc = json.load(f)
        got = {k: prior_doc.get(k) for k in meta}
        if got != meta:
            diffs = {k: (got[k], meta[k]) for k in meta if got[k] != meta[k]}
            sys.exit(f"--start_after merge refused: the prior run's protocol differs "
                     f"(prior vs current): {diffs}. Re-run with matching flags, or delete "
                     f"{out_path} to start over.")
        rows = [r for r in prior_doc.get("rows", []) if r["iteration"] <= args.start_after]
        print(f"merged {len(rows)} prior rows from {out_path}")

    def write_out(complete):
        best = min(rows, key=lambda r: r["fid"])
        with open(out_path, "w") as f:
            json.dump({"rows": rows, "best": best, **meta, "complete": complete}, f,
                      indent=1)

    def timed_fid(feats):
        t0 = time.perf_counter()
        fid = float(frechet_distance(mu_r, sig_r, *feature_stats(feats)))
        return fid, time.perf_counter() - t0

    seconds, fid_seconds = [], []
    pool = ThreadPoolExecutor(max_workers=len(styles))  # idle once the sweep ends
    for snap in snaps:
        t_snap = time.perf_counter()
        it = parse_iteration(snap)
        load_generators(snap, model)
        pending, rates, style_feats = [], [], []
        for style in styles:
            feats = []
            for b, n in batches(src_paths):
                img, _ = model.translate(torch.from_numpy(b), style.expand(len(b), sd),
                                         a2b=a2b, eval_blend=True)
                img01 = (img.float().cpu().numpy() + 1.0) / 2.0
                feats.append(scorer.features(img01)[:n])
                pred = scorer.predict(img01)[:n]
                if pred.shape[1] == 2:
                    rates.append(np.argmax(pred, -1) == (1 if a2b else 0))
            feats = np.concatenate(feats, 0)
            style_feats.append(feats)
            pending.append(pool.submit(timed_fid, feats))
        fids = []
        for done in pending:
            fid, secs = done.result()
            fids.append(fid)
            fid_seconds.append(secs)
        fid = float(np.mean(fids))  # == the single FID when --styles 1
        rate = float(np.mean(np.concatenate(rates))) if rates else float("nan")
        row = {"iteration": it, "fid": round(fid, 3),
               "target_domain_rate": round(rate, 4),
               "n_fake": int(len(style_feats[0])), "n_real": n_real}
        if len(styles) > 1:
            row["fid_styles"] = [round(f, 3) for f in fids]
            row["fid_spread"] = round(max(fids) - min(fids), 3)
        if boot is not None:
            feats_dev = torch.as_tensor(np.stack(style_feats), dtype=torch.float32,
                                        device=model.device)
            point32 = boot.point(feats_dev)
            gen = torch.Generator().manual_seed(args.seed + 17)
            samples = [boot.resample(feats_dev, gen) for _ in range(args.bootstrap)]
            q_lo, q_hi = np.percentile(samples, [2.5, 97.5])
            lo = max(0.0, fid + (point32 - float(q_hi)))
            hi = max(0.0, fid + (point32 - float(q_lo)))
            row["fid_ci95"] = [round(lo, 3), round(hi, 3)]
            row["fid_f32_minus_f64"] = round(point32 - fid, 3)
            if abs(point32 - fid) > 0.5 * max(hi - lo, 1e-6):
                print(f"WARNING iter {it}: f32-eigh point FID {point32:.3f} deviates from "
                      f"f64 scipy {fid:.3f} by more than half the CI width — treat this "
                      f"row's CI as approximate", flush=True)
        rows.append(row)
        write_out(complete=False)
        seconds.append(time.perf_counter() - t_snap)
        extra = ""
        if "fid_spread" in row:
            extra += f"  styles {row['fid_styles']} spread {row['fid_spread']}"
        if "fid_ci95" in row:
            extra += f"  ci95 {row['fid_ci95']}"
        print(f"iter {it:>8}: FID {fid:.3f}  target-domain rate {rate:.4f}{extra} "
              f"({seconds[-1]:.1f} s)", flush=True)

    pool.shutdown()
    best = min(rows, key=lambda r: r["fid"])
    write_out(complete=True)
    hdr = f"| iteration | FID (n={args.n}) | target-domain rate |"
    sep = "|---|---|---|"
    if len(styles) > 1:
        hdr += " style spread |"
        sep += "---|"
    if args.bootstrap:
        hdr += " 95% CI |"
        sep += "---|"
    print("\n" + hdr + "\n" + sep)
    for r in rows:
        sel = " **<- selected**" if r is best else ""
        line = f"| {r['iteration']} | {r['fid']}{sel} | {r['target_domain_rate']} |"
        if len(styles) > 1:
            line += f" {r.get('fid_spread', '')} |"
        if args.bootstrap:
            ci = r.get("fid_ci95")
            line += f" [{ci[0]}, {ci[1]}] |" if ci else " |"
        print(line)
    print(f"\nwrote {out_path}")
    return {"path": out_path, "rows": rows, "seconds": seconds, "fid_seconds": fid_seconds}


if __name__ == "__main__":
    main()
