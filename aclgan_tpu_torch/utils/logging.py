"""Scalar metric writer + HTML gallery (`aclgan_tpu/utils/logging.py`).

Scalars go to a plain `scalars.jsonl` (greppable without TensorBoard) and,
where `torch.utils.tensorboard` imports, to TensorBoard event files; without
the tensorboard package the writer carries on with the JSONL file alone.
`write_html` is the reference's self-refreshing gallery over the saved grids.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except Exception as exc:  # absent, or a tensorboard/protobuf mismatch
                print(f"TensorBoard logging off ({type(exc).__name__}: {exc}); "
                      f"scalars go to scalars.jsonl only")
            else:
                self._tb = SummaryWriter(log_dir)

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        for name, value in scalars.items():
            value = float(value)
            rec[name] = value
            if self._tb is not None:
                self._tb.add_scalar(name, value, step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def _write_one_row_html(html_file, iterations: int, img_filename: str, all_size: int):
    html_file.write("<h3>iteration [%d] (%s)</h3>" % (iterations, img_filename.split("/")[-1]))
    html_file.write(
        """
        <p><a href="%s">
          <img src="%s" style="width:%dpx">
        </a><br>
        <p>
        """ % (img_filename, img_filename, all_size)
    )


def write_html(filename: str, iterations: int, image_save_iterations: int,
               image_directory: str, all_size: int = 1536, ext: str = ".jpg") -> None:
    """Self-refreshing gallery over the saved grids, whose files end in `ext`
    (`.jpg`, or `.png` where `utils/image.py` wrote PNGs)."""
    with open(filename, "w") as html_file:
        html_file.write(
            """
    <!DOCTYPE html>
    <html>
    <head>
      <title>Experiment name = %s</title>
      <meta http-equiv="refresh" content="30">
    </head>
    <body>
    """ % os.path.basename(filename)
        )
        html_file.write("<h3>current</h3>")
        _write_one_row_html(html_file, iterations,
                            "%s/gen_a2b_train_current%s" % (image_directory, ext), all_size)
        for j in range(iterations, image_save_iterations - 1, -1):
            if j % image_save_iterations == 0:
                _write_one_row_html(html_file, j, "%s/gen_a2b_test_%08d%s"
                                    % (image_directory, j, ext), all_size)
                _write_one_row_html(html_file, j, "%s/gen_a2b_train_%08d%s"
                                    % (image_directory, j, ext), all_size)
        html_file.write("</body></html>")


def prepare_sub_folder(output_directory: str):
    """Create images/ + checkpoints/ under the run dir."""
    image_directory = os.path.join(output_directory, "images")
    checkpoint_directory = os.path.join(output_directory, "checkpoints")
    os.makedirs(image_directory, exist_ok=True)
    os.makedirs(checkpoint_directory, exist_ok=True)
    return checkpoint_directory, image_directory
