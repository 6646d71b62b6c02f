"""The port's command lines, the README's workflow (counterparts of the JAX
package's scripts/*.py), each run as `python -m pose6d_tpu_torch.cli.<name>`:

  setup_data                 a LineMOD tree: --synthetic, or a local
                             Linemod_preprocessed.zip
  prepare_yolo               LineMOD ground truth -> the YOLO dataset layout
  train_yolo                 train the YOLOv8n detector
  train                      train a pose variant (--pretrained-backbone)
  compare                    every trained variant's ADD table on a split
  infer                      detect -> crop -> pose on one image, with an overlay PNG
  eval_e2e                   the whole system's ADD metrics over a split
  convert_reference_weights  the reference's PoseNet* .pth <-> a Trainer checkpoint
  demo                       the steps above on a small synthetic tree
  compare_visual             ground truth beside every trained variant, PNG grids
  visualize_yolo             the detector's boxes on random test frames, PNGs
  package_weights            the trained weights into one zip
  setup_weights              unpack that zip and check the layout (no download)
  parity_run                 train variants to saturation on the synthetic fixture
  parity_e2e                 the detector in the loop over parity_run's variants
  probe_components           parity_run's val error split into rotation, xy and z
  reproduce                  the whole chain and the gate against the reference's table

train --mesh DP,TP runs under torchrun, one process per rank (cli/train.py).

Each takes the JAX script's arguments. Those that compute take --device,
"cuda" by default; there is no fallback to the CPU without "--device cpu".
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from .. import DEFAULT_DEVICE


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help=f"torch device to compute on (default {DEFAULT_DEVICE})")


def read_depth_m(path: Optional[str], shape) -> np.ndarray:
    """A depth PNG (uint16 mm) in metres, f32; zeros of `shape` when there is
    no file."""
    from ..data.png import read_depth

    return read_depth(path, shape).astype(np.float32) / 1000.0
