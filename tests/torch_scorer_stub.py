"""A deterministic stand-in for the port's InceptionScorer, and a launcher
that runs `tools/torch_synthfaces_hard.py` with it:

    python tests/torch_scorer_stub.py STAGE --work DIR ...

Its features and its B-rate depend on each image alone, so a curve taken in
one process equals one taken in parts across processes, row for row; no
InceptionV3 forward and no 2048^2 sqrtm."""

import runpy
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "torch_synthfaces_hard.py"


class PixelScorer:
    """Each image's RGB means and four of its gray pixels as features; class
    B for a dark image, A for a light one."""

    pretrained = True

    def __init__(self, *args, **kwargs):
        pass

    def features(self, images01):
        x = np.asarray(images01, np.float64)[..., :3]
        gray = x.mean(-1)[:, ::8, ::8].reshape(len(x), -1)
        return np.concatenate([x.mean((1, 2)), gray], -1)

    def predict(self, images01):
        dark = (np.asarray(images01).mean((1, 2, 3)) < 0.5).astype(np.float64)
        return np.stack([1.0 - dark, dark], -1)


def install() -> None:
    from aclgan_tpu_torch.cli import fid_curve
    from aclgan_tpu_torch.eval import inception

    fid_curve.InceptionScorer = inception.InceptionScorer = PixelScorer


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    install()
    sys.argv = [str(TOOL)] + sys.argv[1:]
    runpy.run_path(str(TOOL), run_name="__main__")
