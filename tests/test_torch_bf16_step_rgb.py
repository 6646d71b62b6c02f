"""Mixed-precision training (TrainConfig compute_dtype "bfloat16") of the
rgb variant: one step of pose6d_tpu_torch against pose6d_tpu's
make_train_step run in float64, from shared flax weights with dropout and
augmentation off, within torch_port_utils.BF16_BOUNDS, the bounds that
JAX's own bf16 step meets (asserted here too, on the same inputs). The
port's towers run bf16 in the step; its parameters stay f32."""

from torch_port_utils import BF16_BOUNDS, bf16_step_errors, few_torch_threads  # noqa: F401


def test_bf16_step_within_jax_bf16_bounds():
    errors = bf16_step_errors("rgb")
    for who in ("jax", "port"):
        for k, bound in BF16_BOUNDS.items():
            assert errors[who][k] <= bound, (who, k, errors[who][k], bound)


def test_bf16_towers_train_in_bf16_and_validate_in_f32():
    """The towers compute in bf16 under the train step and in f32 in the
    eval step (make_eval_step runs f32 whatever the compute dtype); the
    parameters, BN statistics and optimizer moments stay f32."""
    import numpy as np
    import torch

    from pose6d_tpu_torch.losses.add import ObjectModels
    from pose6d_tpu_torch.train import loop as tloop

    S = 32
    cfg = tloop.TrainConfig(variant="rgb", img_size=S, batch_size=2, compute_dtype="bfloat16")
    state = tloop.create_train_state(cfg, device="cpu")
    seen = []
    state.model.backbone.conv1.register_forward_hook(
        lambda m, i, o: seen.append((m.training, o.dtype)))
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32),
             "quat": np.array([[0, 0, 0, 1.0], [0.6, 0, 0, 0.8]], np.float32),
             "trans": np.array([[0, 0, 0.8], [0.05, 0, 0.7]], np.float32),
             "obj_id": np.array([0, 1], np.int32), "center_orig": np.full((2, 2), 16.0, np.float32),
             "cam_K": np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
             "valid": np.array([True, True])}
    state, m = tloop.make_train_step(cfg)(state, batch, torch.Generator().manual_seed(0))
    models = ObjectModels(torch.zeros(2, 8, 3), torch.full((2,), 0.1), torch.zeros(2, dtype=bool),
                          torch.ones(2, dtype=bool), torch.full((2,), 8))
    tloop.make_eval_step(cfg, models)(state, batch)
    assert seen == [(True, torch.bfloat16), (False, torch.float32)]
    assert torch.isfinite(m["loss"]) and all(
        t.dtype == torch.float32 for t in state.model.state_dict().values() if t.is_floating_point())
    moments = state.tx.state_dict()["state"]
    assert moments and all(v["exp_avg"].dtype == torch.float32 for v in moments.values())
