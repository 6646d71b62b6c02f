"""torchvision ResNet50 -> the port's ResNet50 state_dict (counterpart of
pose6d_tpu/models/convert.py).

The reference's published accuracies start from ImageNet-pretrained
torchvision ResNet50 towers (reference models/pose_net_rgb.py:18-19), and
its depth tower's conv1 is the pretrained RGB conv1 summed over the input
channels (models/pose_net_rgbd.py:53-59). Both packages keep torch's
OIHW layout apart from the names, so a torchvision state_dict maps onto
`models.resnet.ResNet50` by renaming alone:

  conv1, bn1                      -> conv1, bn1
  layer{s}.{b}.conv{i} / bn{i}    -> layer{s}_{b}.conv{i} / bn{i}
  layer{s}.{b}.downsample.0 / .1  -> layer{s}_{b}.downsample_conv / downsample_bn
  fc.*                            -> (dropped)

Every tensor becomes float32 on the CPU; num_batches_tracked is 0, as
convert.posenet_from_jax writes it (flax keeps no count). No weights are
downloaded: the user passes a .pth file or a mapping.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

STAGE_SIZES = (3, 4, 6, 3)
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _f32(t) -> torch.Tensor:
    """A float32 CPU copy of a tensor or an array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(t, dtype=np.float32))


def _bn(out: dict, dst: str, get, src: str) -> None:
    for leaf in _BN_LEAVES:
        out[f"{dst}.{leaf}"] = _f32(get(f"{src}.{leaf}"))
    out[f"{dst}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def sum_input_channels(w: torch.Tensor) -> torch.Tensor:
    """[O, C, kh, kw] -> [O, 1, kh, kw], the channels added in index order
    ((c0 + c1) + c2 ..., as numpy's sum over a strided axis adds them)."""
    out = w[:, 0:1].clone()
    for c in range(1, w.shape[1]):
        out = out + w[:, c:c + 1]
    return out


def resnet50_from_torchvision(state_dict: Mapping, sum_conv1_to_1ch: bool = False,
                              prefix: str = "") -> dict:
    """A torchvision resnet50 state_dict (torch tensors or arrays; keys may
    carry `prefix`, e.g. 'backbone.0.' of an nn.Sequential wrap) -> the
    state_dict of models.resnet.ResNet50. sum_conv1_to_1ch gives the depth
    tower's init: conv1 summed over its 3 input channels."""
    get = lambda k: state_dict[prefix + k]  # noqa: E731
    out = {}
    conv1 = _f32(get("conv1.weight"))
    out["conv1.weight"] = sum_input_channels(conv1) if sum_conv1_to_1ch else conv1
    _bn(out, "bn1", get, "bn1")
    for s, n_blocks in enumerate(STAGE_SIZES):
        for b in range(n_blocks):
            src, dst = f"layer{s + 1}.{b}", f"layer{s + 1}_{b}"
            for i in (1, 2, 3):
                out[f"{dst}.conv{i}.weight"] = _f32(get(f"{src}.conv{i}.weight"))
                _bn(out, f"{dst}.bn{i}", get, f"{src}.bn{i}")
            if prefix + f"{src}.downsample.0.weight" in state_dict:
                out[f"{dst}.downsample_conv.weight"] = _f32(get(f"{src}.downsample.0.weight"))
                _bn(out, f"{dst}.downsample_bn", get, f"{src}.downsample.1")
    return out


def resnet50_to_torchvision(state: Mapping) -> dict:
    """Inverse of resnet50_from_torchvision (no fc): the port's ResNet50
    state_dict -> torchvision key names, num_batches_tracked 0."""
    out = {"conv1.weight": _f32(state["conv1.weight"])}
    _bn(out, "bn1", state.__getitem__, "bn1")
    for s, n_blocks in enumerate(STAGE_SIZES):
        for b in range(n_blocks):
            src, dst = f"layer{s + 1}_{b}", f"layer{s + 1}.{b}"
            for i in (1, 2, 3):
                out[f"{dst}.conv{i}.weight"] = _f32(state[f"{src}.conv{i}.weight"])
                _bn(out, f"{dst}.bn{i}", state.__getitem__, f"{src}.bn{i}")
            if f"{src}.downsample_conv.weight" in state:
                out[f"{dst}.downsample.0.weight"] = _f32(state[f"{src}.downsample_conv.weight"])
                _bn(out, f"{dst}.downsample.1", state.__getitem__, f"{src}.downsample_bn")
    return out


def s2d_conv1_weights(w7: torch.Tensor) -> torch.Tensor:
    """A [O, C, 7, 7] stem kernel -> the equivalent [O, 4C, 4, 4] kernel of
    the space-to-depth stem (models/resnet.py): the 7x7 kernel padded to
    8x8 by a zero row and column at the top left (pad 3/3 becomes 4/3),
    each 2x2 tap block folded into the channels in (dy, dx, c) order. The
    4x4/s1 conv with pad (2, 1) on the 2x2-block input is then the 7x7/s2
    conv."""
    O, C, kh, kw = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"s2d_conv1_weights: a 7x7 kernel, got {kh}x{kw}")
    w8 = w7.new_zeros(O, C, 8, 8)
    w8[:, :, 1:, 1:] = w7
    # [o, c, 2m + dy, 2n + dx] -> [o, (dy, dx, c), m, n]
    w2 = w8.reshape(O, C, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return w2.reshape(O, 4 * C, 4, 4).contiguous()


def load_torch_state_dict(path: str) -> dict:
    """A state_dict from a .pth file, loaded on the CPU with
    weights_only=True (tensors and plain containers only); a checkpoint
    dict holding it under 'state_dict', 'model_state_dict' or 'model' is
    unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in ("state_dict", "model_state_dict", "model"):
            if key in obj and isinstance(obj[key], dict):
                return obj[key]
    return obj
