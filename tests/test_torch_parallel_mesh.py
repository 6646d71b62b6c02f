"""pose6d_tpu_torch/parallel against the JAX package's rules and the
one-process arithmetic: param_spec against pose6d_tpu.parallel.param_spec
on every parameter of the four variants (under the converter's names),
make_mesh's shapes and errors (tests/test_parallel.py's, on a world of 8
gloo processes), shard -> gather as the identity on parameters and on a
TrainState with AdamW moments, and each collective's forward and backward
against the one-process float64 block (torch_parallel_utils)."""

import numpy as np
import pytest
import torch

import torch_parallel_utils as U

VARIANTS = ["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"]


def _flax_leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flax_leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("variant", VARIANTS)
def test_param_spec_agrees_with_jax(variant):
    """The same split axis, or replicated, for every flax parameter (tp) and
    BatchNorm statistic (replicated, as shard_state puts them) under the
    names convert.posenet_from_jax gives them; every port tensor answers."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
    from pose6d_tpu.parallel import param_spec as jax_param_spec
    from pose6d_tpu.train.loop import model_inputs
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
    from pose6d_tpu_torch.parallel import param_spec

    S = U.S
    dummy = {"rgb": jnp.zeros((1, S, S, 3)), "depth": jnp.zeros((1, S, S, 1)),
             "depth_raw": jnp.zeros((1, S, S)), "center_orig": jnp.zeros((1, 2)),
             "center_crop": jnp.zeros((1, 2)), "cam_K": jnp.eye(3)[None],
             "cam_K_crop": jnp.eye(3)[None]}
    shapes = jax.eval_shape(lambda: JPoseNet(JPoseNetConfig(variant=variant, img_size=S)).init(
        jax.random.key(0), **model_inputs(variant, dummy, dummy["rgb"])))
    sd = PoseNet(PoseNetConfig(variant=variant, img_size=S)).state_dict()
    names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
    seen, n_split = set(), 0
    for collection, tp in (("params", True), ("batch_stats", False)):
        for path, leaf in _flax_leaves(shapes[collection]):
            name = ".".join(path[:-1]) + "." + names[path[-1]]
            spec = jax_param_spec(path, leaf, tp)
            if spec == P():
                want = None
            elif len(leaf.shape) == 2:  # a dense kernel [in, out] is torch's [out, in]
                want = 1 - list(spec).index("model")
            else:
                want = list(spec).index("model")
            assert param_spec(name, sd[name], tp) == want, (name, spec)
            n_split += want is not None
            seen.add(name)
    assert n_split >= 3  # rot_dense0 weight and bias, rot_dense1 weight at least
    for name, t in sd.items():
        if name not in seen:  # torch's BatchNorm step count: no flax leaf
            assert name.endswith("num_batches_tracked") and param_spec(name, t, True) is None


def test_make_mesh_shapes_and_errors(tmp_path):
    """tests/test_parallel.py:42-47 on 8 ranks: the default mesh is all
    data, (4, 2) is {"data": 4, "model": 2}; rank r sits at (r // tp,
    r % tp), its data group the ranks of its model column; a shape that
    does not cover the world raises as JAX's does."""
    runs = U.run_world(U.mesh_rank, 8, tmp_path)
    for r, out in enumerate(runs):
        assert out[None][0] == {"data": 8, "model": 1}
        assert out[(4, 2)][0] == {"data": 4, "model": 2}
        assert out[(2, 4)][0] == {"data": 2, "model": 4}
        for shape in ((4, 2), (2, 4), (1, 8)):
            _, d, m, data_ranks, model_ranks, di, mi = out[shape]
            tp = shape[1]
            assert (d, m) == (r // tp, r % tp)
            assert data_ranks == tuple(range(m, 8, tp)) and di == d
            assert model_ranks == tuple(range(d * tp, d * tp + tp)) and mi == m
        assert out["error"] == "mesh shape (3, 2) != 8 devices"


def test_make_mesh_needs_a_process_group():
    from pose6d_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1))


def test_shard_then_gather_is_the_identity(tmp_path):
    """On (2, 2), for rgb and rgbd: gather_params(shard_params(sd)) == sd
    and gather_state(shard_state(state)) == state bit for bit, AdamW's
    moments included; the split tensors are the heads' dense0 weight and
    bias and dense1 weight, each rank holding half of the split dim."""
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig

    variants = ("rgb", "rgbd")
    runs = U.run_world(U.shard_gather_rank, 4, tmp_path, (2, 2), variants)
    for variant in variants:
        prefixes = ("rot_", "trans_") + (("fusion_",) if variant == "rgbd" else ())
        want = sorted([f"{p}dense0.weight" for p in prefixes]
                      + [f"{p}dense0.bias" for p in prefixes]
                      + [f"{p}dense1.weight" for p in prefixes])
        full = PoseNet(PoseNetConfig(variant=variant, img_size=U.S)).state_dict()
        for out in (r[variant] for r in runs):
            assert out["bad"] == []
            assert out["split"] == want
            for k, shape in out["shapes"].items():
                d = 1 if "dense1" in k else 0
                expect = list(full[k].shape)
                expect[d] //= 2
                assert list(shape) == expect, k


def test_collectives_and_their_gradients(tmp_path):
    """Each collective's backward against the one-process float64
    gradient, on (2, 2): copy_to_group (all-reduce), reduce_from_group
    (identity), reduce_sum (all-reduce; LayerNorm over the model group,
    BatchNorm over the data group), gather_rows (this rank's rows). A
    row-parallel output through torch.distributed.nn's all_reduce, which
    all-reduces in backward too, doubles the first layer's gradient."""
    runs = U.run_world(U.collectives_rank, 4, tmp_path, (2, 2))
    for out in runs:
        assert max(out["errs"].values()) <= 1e-12, out["errs"]
        assert abs(out["wrong_ratio"] - 2.0) < 1e-9, out["wrong_ratio"]


def test_shard_batch_takes_the_rank_rows():
    from pose6d_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh, shard_batch

    mesh = Mesh({DATA_AXIS: 4, MODEL_AXIS: 1}, 2, 2, 0, None, None, None)
    batch = {"a": np.arange(8), "b": {"c": torch.arange(16).reshape(8, 2)}}
    out = shard_batch(batch, mesh)
    assert out["a"].tolist() == [4, 5] and out["b"]["c"].tolist() == [[8, 9], [10, 11]]
    stacked = shard_batch({"m": torch.arange(24).reshape(3, 8)}, mesh, dim=1)
    assert stacked["m"].tolist() == [[4, 5], [12, 13], [20, 21]]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch({"a": np.arange(6)}, mesh)


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_head_widths_split_over_the_model_axis(tp):
    """Every split width of the four variants' heads (4096 -> 1024, 2048,
    1024, 512, 256, 128 columns) divides a model axis of 2 or 4; 3 raises
    before anything is changed. Built on a mesh description alone (no
    collective runs while the heads are split)."""
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
    from pose6d_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, Group, Mesh, shard_posenet
    from pose6d_tpu_torch.parallel.heads import ColumnParallelLinear, RowParallelLinear

    group = Group(None, tuple(range(tp)), tp - 1)
    mesh = Mesh({DATA_AXIS: 1, MODEL_AXIS: tp}, tp - 1, 0, tp - 1, Group(None, (0,), 0), group,
                group)
    for variant in ("rgb", "rgb_geometric", "rgbd", "rgbd_geometric"):
        model = PoseNet(PoseNetConfig(variant=variant, img_size=U.S))
        if tp == 3:
            with pytest.raises(ValueError, match="model axis of 3"):
                shard_posenet(model, mesh)
            assert model.mesh is None
            continue
        full = {k: v.clone() for k, v in model.state_dict().items()}
        shard_posenet(model, mesh)
        cols = [m for m in model.modules() if isinstance(m, ColumnParallelLinear)]
        rows = [m for m in model.modules() if isinstance(m, RowParallelLinear)]
        assert len(cols) == len(rows) >= 1
        for name, m in model.named_modules():
            if isinstance(m, ColumnParallelLinear):
                n = m.out_features
                assert torch.equal(m.weight, full[f"{name}.weight"][-n:])
            elif isinstance(m, RowParallelLinear):
                n = m.in_features
                assert torch.equal(m.weight, full[f"{name}.weight"][:, -n:])
                assert torch.equal(m.bias, full[f"{name}.bias"])
