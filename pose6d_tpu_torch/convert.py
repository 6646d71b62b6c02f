"""Weights for the port: carried across from flax trees, or made from a seed.

The port's modules carry the flax scope names as attribute names, so a flax
variables tree ({"params": ..., "batch_stats": ...}, nested dicts of numpy
arrays) maps onto a state_dict by a transpose table:

  conv kernel [kh, kw, ci, co] (HWIO)  -> weight [co, ci, kh, kw] (OIHW)
  dense kernel [in, out]               -> weight [out, in]
  BatchNorm / LayerNorm scale, bias    -> weight, bias
  batch_stats mean, var                -> running_mean, running_var

The int8 serving trees of the JAX package (PosePipeline.quantize_backbones)
come across the same way (`quantized_from_jax`): int8 HWIO codes -> OHWI.

`init_posenet_weights` / `init_yolo_weights` make He-scaled weights from a
numpy seed with every BatchNorm's scale, bias, mean and variance randomised
(bn3 included), so BN folding and the residual branches are never trivial.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.posenet import PoseNet, PoseNetConfig
from .models.yolo.model import YoloConfig, YoloV8


def _leaves(tree, prefix=(), dtype=np.float32):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,), dtype)
        else:
            yield prefix + (k,), np.asarray(v, dtype)


def _flax_to_state_dict(variables, dtype=np.float32) -> dict:
    """A flax variables tree -> state_dict tensors of `dtype`."""
    sd = {}
    for path, a in _leaves(variables["params"], dtype=dtype):
        scope, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            sd[f"{scope}.weight"] = a
        elif leaf == "scale":
            sd[f"{scope}.weight"] = a
        elif leaf == "bias":
            sd[f"{scope}.bias"] = a
        else:
            raise KeyError(f"unexpected flax param {'/'.join(path)}")
    for path, a in _leaves(variables.get("batch_stats", {}), dtype=dtype):
        scope, leaf = ".".join(path[:-1]), path[-1]
        sd[f"{scope}.running_{leaf}"] = a
        sd[f"{scope}.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def posenet_from_jax(variables) -> dict:
    """A flax PoseNet tree -> the port's PoseNet state_dict."""
    return _flax_to_state_dict(variables)


def yolo_from_jax(variables) -> dict:
    """A flax YoloV8 tree -> the port's YoloV8 state_dict."""
    return _flax_to_state_dict(variables)


def _adam_state(opt_state):
    """(mu, nu, count) of the Adam state inside an optax state tree: the
    ScaleByAdamState namedtuple, or the dict that a checkpoint restored
    without its structure holds in its place."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu, opt_state.nu, opt_state.count
    if isinstance(opt_state, dict):
        if "mu" in opt_state and "nu" in opt_state:
            return opt_state["mu"], opt_state["nu"], opt_state["count"]
        children = opt_state.values()
    elif isinstance(opt_state, (list, tuple)):
        children = opt_state
    else:
        children = ()
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def det_trainer_state_from_jax(tree) -> dict:
    """The JAX DetectionTrainer's checkpoint tree (its _ckpt_tree(): params,
    batch_stats, ema_params, opt_state, meta; as numpy, e.g. as orbax
    restores it) -> the port's DetectionTrainer checkpoint tree
    (models/yolo/train.DetectionTrainer.load_tree): parameters, BatchNorm
    buffers, EMA parameters and Adam's moments in the state_dict layout
    (yolo_from_jax's transposes), Adam's count, and the meta values."""
    state = yolo_from_jax({"params": tree["params"], "batch_stats": tree["batch_stats"]})
    params = _flax_to_state_dict({"params": tree["params"]})
    found = _adam_state(tree["opt_state"])
    if found is None:
        raise KeyError("no Adam state (mu, nu, count) in the optax state")
    mu, nu, count = found
    meta = tree["meta"]
    return {
        "params": params,
        "batch_stats": {k: v for k, v in state.items() if k not in params},
        "ema_params": _flax_to_state_dict({"params": tree["ema_params"]}),
        "opt_state": {"mu": _flax_to_state_dict({"params": mu}),
                      "nu": _flax_to_state_dict({"params": nu}), "count": int(np.asarray(count))},
        "meta": {"global_step": int(np.asarray(meta["global_step"])),
                 "epoch": int(np.asarray(meta["epoch"])),
                 "best_map": float(np.asarray(meta["best_map"]))},
    }


def quantized_from_jax(q) -> dict:
    """A JAX int8 tree, of a ResNet50 tower (ops/quant.py quantize_folded:
    {name: {"w": HWIO int8 codes, "s", "b", "a"}}) or of the detector
    (models/yolo/quant.py, whose head output convs are {"w": HWIO f32, "b",
    "float": True}), as numpy -> the port's: OHWI codes, OIHW float
    kernels, tensors on the CPU."""
    conv = {}
    for name, e in q.items():
        w = np.asarray(e["w"])
        if e.get("float"):
            conv[name] = {"w": torch.from_numpy(w.astype(np.float32).transpose(3, 2, 0, 1).copy()),
                          "b": torch.from_numpy(np.array(e["b"], np.float32)), "float": True}
            continue
        conv[name] = {"w": torch.from_numpy(w.astype(np.int8).transpose(3, 0, 1, 2).copy()),
                      "s": torch.from_numpy(np.array(e["s"], np.float32)),
                      "b": torch.from_numpy(np.array(e["b"], np.float32)),
                      "a": torch.tensor(np.float32(e["a"]))}
    return conv


def _random_state(module: torch.nn.Module, seed: int) -> dict:
    """He-scaled random weights for every entry of module's state_dict."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    sd = {}
    for key, shape in shapes.items():
        scope, leaf = key.rsplit(".", 1)
        is_bn = f"{scope}.running_mean" in shapes
        residual_end = ".layer" in scope and scope.endswith(("bn3", "downsample_bn"))
        if leaf == "num_batches_tracked":
            a = np.zeros((), np.int64)
        elif leaf == "running_mean":
            a = rng.normal(0.0, 0.1, shape)
        elif leaf == "running_var":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "weight" and is_bn:
            # residual-branch ends get smaller gammas so that 16 stacked
            # blocks keep activations in range; never zero
            a = rng.uniform(0.2, 0.5, shape) if residual_end else rng.uniform(0.5, 1.2, shape)
        elif leaf == "weight" and len(shape) == 1:  # LayerNorm
            a = rng.uniform(0.8, 1.2, shape)
        elif leaf == "weight":
            fan_in = int(np.prod(shape[1:]))
            gain = 2.0 if len(shape) == 4 else 1.0  # He for convs, LeCun for dense
            a = rng.normal(0.0, np.sqrt(gain / fan_in), shape)
        elif leaf == "bias":
            a = rng.normal(0.0, 0.1 if is_bn else 0.02, shape)
        else:
            raise KeyError(f"no init rule for {key}")
        sd[key] = torch.from_numpy(np.asarray(a, np.int64 if leaf == "num_batches_tracked"
                                              else np.float32))
    return sd


def init_posenet_weights(cfg: PoseNetConfig, seed: int) -> dict:
    """Seeded PoseNet state_dict for any variant (no checkpoint needed).
    The learned z starts at 0.5 m, the reference's typical-depth init: the
    translation head's z bias (rgb, rgbd) or the z head's bias
    (rgb_geometric)."""
    with torch.device("meta"):
        model = PoseNet(cfg)
    sd = _random_state(model, seed)
    for key, index in (("trans_out.bias", 2), ("z_out.bias", 0)):
        if key in sd:
            sd[key][index] = 0.5
    return sd


def init_torchvision_resnet50(seed: int) -> dict:
    """A seeded state_dict in torchvision's resnet50 layout (fc included;
    num_batches_tracked 1): the stand-in for ImageNet weights where no
    download is possible (models/convert.resnet50_from_torchvision reads
    it)."""
    from .models.convert import resnet50_to_torchvision
    from .models.resnet import ResNet50

    with torch.device("meta"):
        tower = ResNet50()
    sd = resnet50_to_torchvision(_random_state(tower, seed))
    rng = np.random.default_rng(seed + 1)
    sd["fc.weight"] = torch.from_numpy(rng.normal(0.0, 0.02, (1000, 2048)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    for k in sd:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.ones((), dtype=torch.int64)
    return sd


def init_yolo_weights(cfg: YoloConfig, seed: int) -> dict:
    """Seeded YoloV8 state_dict."""
    with torch.device("meta"):
        model = YoloV8(cfg)
    return _random_state(model, seed)
