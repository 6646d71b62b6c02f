"""Mixed-precision training (TrainConfig compute_dtype "bfloat16") of the
rgbd variant: one step of pose6d_tpu_torch against pose6d_tpu's
make_train_step run in float64, from shared flax weights with dropout and
augmentation off, within torch_port_utils.BF16_BOUNDS, the bounds that
JAX's own bf16 step meets (asserted here too, on the same inputs). The
port's towers run bf16 in the step; its parameters stay f32."""

from torch_port_utils import BF16_BOUNDS, bf16_step_errors, few_torch_threads  # noqa: F401


def test_bf16_step_within_jax_bf16_bounds():
    errors = bf16_step_errors("rgbd")
    for who in ("jax", "port"):
        for k, bound in BF16_BOUNDS.items():
            assert errors[who][k] <= bound, (who, k, errors[who][k], bound)
