"""One train step of the single-tower variants (rgb, rgb_geometric) of
pose6d_tpu_torch against pose6d_tpu's make_train_step, from shared flax
weights with dropout and augmentation off: loss, gradient global norm,
every gradient leaf and the updated BN statistics (tolerances and why the
reference runs in float64: torch_port_utils.one_train_step_both and
assert_train_step_parity); and the eval step's metrics against
make_eval_step (rgb_geometric, whose deployed metric is its own)."""

import pytest

from torch_port_utils import (assert_eval_parity, assert_train_step_parity, eval_step_both,
                              one_train_step_both)


@pytest.mark.parametrize("variant", ["rgb", "rgb_geometric"])
def test_one_step_matches_jax(variant):
    jax_out, runs, variables, batch = one_train_step_both(variant)
    assert_train_step_parity(jax_out, runs)
    if variant == "rgb_geometric":
        assert_eval_parity(*eval_step_both(variant, variables, batch))
