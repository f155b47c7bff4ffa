"""Checkpoint converter — `python -m aclgan_tpu_torch.cli.convert --config <yaml>
--gen gen_00350000.msgpack [--dis dis_00350000.msgpack] --output_dir checkpoints/`.

The flags of `aclgan_tpu/cli/convert.py`, plus `--device`. `--gen` / `--dis`
are each a JAX `.msgpack` (a snapshot of the JAX package or its converter:
flax params; the dis `{'params', 'spectral'[, 'batch_stats']}`) or a
reference / port `.pt` (`{'AB', 'BA'}` / `{'A', 'B', '2'}` state dicts). Each
is loaded into the port's networks, so a file of the wrong shape fails here and
not at resume, with bn running stats and sn u / v carried, and written as port
`gen_/dis_%08d.pt` beside an `imported.marker`: the train CLI's `--resume`
then starts from these weights with fresh optimizer moments. The iteration
stamp is parsed from the `--gen` file name unless `--iteration` gives it.
Like every port entry point it runs on CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os

from aclgan_tpu_torch.config import load_config
from aclgan_tpu_torch.trainer import ACLGAN
from aclgan_tpu_torch.utils.checkpoint import (load_discriminators, load_generators,
                                               save_discriminators, save_generators)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--gen", type=str, required=True, help="gen_*.pt or .msgpack path")
    parser.add_argument("--dis", type=str, default=None, help="dis_*.pt or .msgpack path")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--iteration", type=int, default=None,
                        help="iteration stamp; default parsed from filename")
    parser.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    opts = parser.parse_args(argv)

    cfg = load_config(opts.config)
    model = ACLGAN(cfg, device=opts.device)
    model.init_state()

    if opts.iteration is not None:
        it = opts.iteration
    else:
        stem = os.path.basename(opts.gen).split(".")[0]
        try:
            it = int(stem.split("_")[-1])
        except ValueError:
            it = 0

    os.makedirs(opts.output_dir, exist_ok=True)
    load_generators(opts.gen, model)
    gen_out = os.path.join(opts.output_dir, "gen_%08d.pt" % it)
    save_generators(gen_out, model)
    print(f"wrote {gen_out}")
    if opts.dis:
        load_discriminators(opts.dis, model)
        dis_out = os.path.join(opts.output_dir, "dis_%08d.pt" % it)
        save_discriminators(dis_out, model)
        print(f"wrote {dis_out}")
    # a deliberate import: resume accepts the missing optimizer file (fresh
    # moments) only beside this marker
    with open(os.path.join(opts.output_dir, "imported.marker"), "w"):
        pass


if __name__ == "__main__":
    main()
