"""Export a generator checkpoint as a self-contained serving artifact.

    python -m aclgan_tpu_torch.cli.export --config configs/male2female.yaml \
        --checkpoint outputs/male2female/checkpoints/gen_00350000.pt \
        --output male2female_a2b.aclt --batch 32

The flags of `aclgan_tpu.cli.export`, with `--device cuda|cpu` (the device
the step is traced on; default cuda, which raises without a card) in place
of `--platforms`. The artifact embeds the `torch.export` graph and the
weights; serve it with `aclgan_tpu_torch.export.ExportedTranslator` or
`python -m aclgan_tpu_torch.serving_http --artifact`. It needs `torch` and
the port's kernel module (which registers K1's op), and no checkpoint,
config or model code. A program traced on the CPU runs on the card too
(`ExportedTranslator` moves it to the device asked for).
"""

from __future__ import annotations

import argparse
import os
import sys

from aclgan_tpu_torch.export import export_translator, kernel_nodes, save_artifact


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True,
                   help="gen_*.pt or gen_*.msgpack")
    p.add_argument("--output", type=str, required=True,
                   help="artifact path (convention: .aclt)")
    p.add_argument("--a2b", type=int, default=1, help="1 for a2b, 0 for b2a")
    p.add_argument("--batch", type=int, default=32,
                   help="static batch (requests pad to it)")
    p.add_argument("--size", type=int, default=0,
                   help="square input size (default: config new_size)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to trace on")
    opts = p.parse_args(argv)

    if opts.batch < 1:
        sys.exit(f"--batch must be >= 1, got {opts.batch}")
    if not os.path.exists(opts.checkpoint):
        sys.exit(f"checkpoint not found: {opts.checkpoint}")

    exported, meta = export_translator(
        opts.config, opts.checkpoint, a2b=bool(opts.a2b),
        batch_size=opts.batch, size=opts.size or None, device=opts.device)
    save_artifact(exported, meta, opts.output)
    sz = os.path.getsize(opts.output)
    print(f"wrote {opts.output} ({sz / 1e6:.1f} MB): "
          f"batch={meta['batch_size']} size={meta['size']} a2b={meta['a2b']} "
          f"device={meta['device']} kernel nodes={kernel_nodes(exported)}")
    return meta


if __name__ == "__main__":
    main()
