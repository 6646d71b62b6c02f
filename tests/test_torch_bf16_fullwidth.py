"""The bf16 float towers at full width against flax's: chip_smoke phase
20's configuration (ResNet50 towers at 224, BATCH frames of 640x480, its
seeded weights and frames), run on the CPU. Slow: a ResNet50-sized
program, out of tier-1.

The crops are the port's bf16 pipeline's (crop_stage), which every arm
shares; the PoseNet weights go to flax through the reference layout
(posenet_to_reference, then JAX's posenet_torch_to_flax). Three pose
distances, each the max absolute difference over the pipeline's
quaternion components and metres (the port's X/Y correction applied to
every arm's poses):
  d_J  flax PoseNet(dtype=bfloat16) against PoseNet(dtype=float32), op by
       op (jax.disable_jit, as test_torch_bf16_serving.py runs it), and
       jitted (d_J_jit);
  d_P  the port's PoseNetConfig(dtype=torch.bfloat16) against its f32;
  d_X  the port's bf16 against flax's bf16 (op by op; d_X_jit jitted).
It asserts d_X <= MULT d_J + FLOOR (test_torch_bf16_serving.py's rule)
and prints the distances and each tower's feature distances.

  JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bf16_fullwidth.py -m slow -s
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.models.convert_posenet import posenet_torch_to_flax
from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
from pose6d_tpu_torch.convert import init_posenet_weights, init_yolo_weights
from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
from pose6d_tpu_torch.models.convert_posenet import posenet_to_reference
from pose6d_tpu_torch.models.posenet import PoseNetConfig
from pose6d_tpu_torch.models.yolo.model import YoloConfig

MULT, FLOOR = 2.0, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase20_requests(cs) -> dict:
    """{variant: (index, frames, depth or None)} as phase_bf16_float draws
    them from its generator, with phase_add's draws between the rows."""
    rng = np.random.default_rng(cs.SEED + 21)
    out = {}
    for i, variant in enumerate(cs.BF16_FLOAT_ROWS):
        frames = rng.integers(0, 256, (cs.BATCH, cs.FRAME_H, cs.FRAME_W, 3), dtype=np.uint8)
        depth = (rng.uniform(0.2, 1.5, (cs.BATCH, cs.FRAME_H, cs.FRAME_W)).astype(np.float32)
                 if variant == "rgbd" else None)
        out[variant] = (i, frames, depth)
        cs.seeded_object_models(rng, "cpu")
        cs.seeded_poses(rng, cs.BATCH, "cpu")
        rng.integers(0, 13, cs.BATCH)
    return out


def _dist(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in ("rotation", "translation"))


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["rgb", "rgbd"])
def test_bf16_towers_at_full_width_match_flax(variant):
    cs = _chip_smoke()
    i, frames, depth = phase20_requests(cs)[variant]
    yolo_state = init_yolo_weights(YoloConfig(), cs.SEED + 1)
    pose_state = init_posenet_weights(PoseNetConfig(variant=variant), cs.SEED + 30 + i)
    cfg = PipelineConfig(variant=variant, img_size=224, conf_thresh=0.0,
                         compute_dtype=torch.bfloat16,
                         nms_pre_topk=32 if variant == "rgbd" else 64)
    pipes = {dt: PosePipeline(cfg, YoloConfig(dtype=torch.bfloat16), yolo_state, pose_state,
                              None if dt == "bf16" else PoseNetConfig(variant=variant),
                              device="cpu") for dt in ("bf16", "f32")}
    K = torch.from_numpy(cs.LINEMOD_K)
    with torch.inference_mode():
        st = pipes["bf16"].crop_stage(torch.from_numpy(frames), K,
                                      None if depth is None else torch.from_numpy(depth))
        inputs = st["inputs"]
        poses = {f"P_{dt}": pipe._outputs(*pipe.pose_forward(inputs), st, K)
                 for dt, pipe in pipes.items()}

    variables = posenet_torch_to_flax(variant, posenet_to_reference(variant, pose_state))
    jin = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16 if v.dtype == torch.bfloat16
                          else jnp.float32) for k, v in inputs.items()}
    towers = ("rgb_backbone", "depth_backbone") if variant == "rgbd" else ("backbone",)
    feats = {}
    for jit in (False, True):
        for dt in (jnp.bfloat16, jnp.float32):
            model = JPoseNet(JPoseNetConfig(variant=variant, dtype=dt))
            name = f"J_{jnp.dtype(dt).name}{'_jit' if jit else ''}"
            if jit:
                rot, trans = jax.jit(model.apply)(variables, **jin)
            else:
                with jax.disable_jit():
                    (rot, trans), seen = model.apply(
                        variables, **jin, mutable=["intermediates"],
                        capture_intermediates=lambda m, fn: fn == "__call__" and m.name in towers)
                feats[name] = {t: np.asarray(seen["intermediates"][t]["__call__"][0], np.float32)
                               for t in towers}
            with torch.inference_mode():
                poses[name] = pipes["bf16"]._outputs(
                    torch.from_numpy(np.array(rot, np.float32)),
                    torch.from_numpy(np.array(trans, np.float32)), st, K)
    with torch.inference_mode():
        port_feats = pipes["bf16"].posenet.tower_features(
            pipes["bf16"].posenet.tower_inputs(inputs["rgb"], inputs.get("depth")))

    d = {"d_J": _dist(poses["J_bfloat16"], poses["J_float32"]),
         "d_J_jit": _dist(poses["J_bfloat16_jit"], poses["J_float32_jit"]),
         "d_P": _dist(poses["P_bf16"], poses["P_f32"]),
         "d_X": _dist(poses["P_bf16"], poses["J_bfloat16"]),
         "d_X_jit": _dist(poses["P_bf16"], poses["J_bfloat16_jit"]),
         "f32_port_vs_flax": _dist(poses["P_f32"], poses["J_float32"])}
    print(f"\n{variant} at 224, batch {cs.BATCH}: "
          + ", ".join(f"{k} {v:.4g}" for k, v in d.items()))
    for t in towers:
        jb, jf = feats["J_bfloat16"][t], feats["J_float32"][t]
        pb = port_feats[t].float().numpy()
        scale = float(np.abs(jf).max())
        print(f"  {t} features, max abs / max |f32|: flax bf16 vs f32 "
              f"{np.abs(jb - jf).max() / scale:.3g}, port bf16 vs flax f32 "
              f"{np.abs(pb - jf).max() / scale:.3g}, port bf16 vs flax bf16 "
              f"{np.abs(pb - jb).max() / scale:.3g}")
    assert d["f32_port_vs_flax"] <= 1e-4, "the f32 towers part: the weights or crops differ"
    assert d["d_X"] <= MULT * d["d_J"] + FLOOR, d
