"""Shared helper for the tests that hold pose6d_tpu_torch against the JAX
package: flax variables with every BatchNorm randomised, as numpy trees."""

from __future__ import annotations

import numpy as np


def random_flax_variables(model, *args, seed: int = 0, **kwargs):
    """Random variables for a flax module without running its init: the
    tree's shapes come from jax.eval_shape (tracing only), the values from
    numpy. Conv/dense kernels are He-scaled, every BatchNorm's scale, bias,
    mean and var and every bias are random (no zero-init residuals)."""
    import jax

    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(tree, stats):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = fill(v, stats)
                continue
            shape = v.shape
            if stats:
                a = rng.normal(0, 0.1, shape) if k == "mean" else rng.uniform(0.5, 1.5, shape)
            elif k == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                a = rng.normal(0, np.sqrt((2.0 if len(shape) == 4 else 1.0) / fan_in), shape)
            elif k == "scale":
                a = rng.uniform(0.5, 1.2, shape)
            else:
                a = rng.normal(0, 0.05, shape)
            out[k] = a.astype(np.float32)
        return out

    return {"params": fill(shapes["params"], False),
            "batch_stats": fill(shapes.get("batch_stats", {}), True)}


def random_folded_stage(rng, stage: int):
    """A random BN-folded tree of one ResNet50 stage: ({name: {"w" HWIO,
    "b"}} numpy in the JAX layout, the same as {name: {"w" OIHW, "b"}}
    torch tensors). Weights are N(0, 1/fan_in), biases N(0, 0.05), so
    activations stay of order one through every stage."""
    import torch

    from pose6d_tpu_torch.ops.fused_block import STAGE_CFGS

    name, n_blocks, _, cin, cmid, cout, _, _ = STAGE_CFGS[stage]
    specs = {f"{name}_0/downsample": (1, cin, cout)}
    for j in range(n_blocks):
        specs.update({f"{name}_{j}/conv1": (1, cin if j == 0 else cout, cmid),
                      f"{name}_{j}/conv2": (3, cmid, cmid),
                      f"{name}_{j}/conv3": (1, cmid, cout)})
    jtree, ttree = {}, {}
    for n, (k, ci, co) in specs.items():
        w = (rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci)).astype(np.float32)
        b = (rng.standard_normal((co,)) * 0.05).astype(np.float32)
        jtree[n] = {"w": w, "b": b}
        ttree[n] = {"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                    "b": torch.from_numpy(b)}
    return jtree, ttree
