"""pose6d_tpu_torch.models.convert (torchvision ResNet50 -> the port's
ResNet50, and the space-to-depth stem) against the JAX package.

A pure-torch torchvision ResNet50 (tests/torch_ref_utils.py) with every
weight and BatchNorm statistic drawn from a numpy seed goes two ways: the
port's resnet50_from_torchvision (chain A), and the JAX package's
torchvision_resnet50_to_flax followed by convert.posenet_from_jax's
transposes (chain B). The two state_dicts are bit-equal, plain, with the
depth tower's summed conv1 and under a prefix. Forwards at 64 px: the
port's tower against the torch reference's eval forward within 1e-5
relative; the s2d kernel bit-equal to JAX's; the port's s2d stem against
its 7x7 stem within 1e-5 relative, and against one JAX forward of
ResNet50(stem_space_to_depth=True) on the same tree within 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.models.convert import s2d_conv1_weights as j_s2d
from pose6d_tpu.models.convert import torchvision_resnet50_to_flax
from pose6d_tpu.models.resnet import ResNet50 as JResNet50
from pose6d_tpu_torch.convert import _flax_to_state_dict
from pose6d_tpu_torch.models import convert as pc
from pose6d_tpu_torch.models.resnet import ResNet50

from torch_port_utils import few_torch_threads  # noqa: F401
from torch_ref_utils import TorchResNet50

S = 64


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def tv():
    """A torchvision-layout ResNet50, every tensor from a numpy seed:
    He-scaled convs, BN scales in [0.5, 1.2] ([0.2, 0.5] at each block's
    last BN), biases and means ~N(0, 0.1), variances in [0.5, 1.5]."""
    model = TorchResNet50().eval()
    rng = np.random.default_rng(5)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
            continue
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif v.ndim == 4:
            a = rng.normal(0, np.sqrt(2.0 / np.prod(shape[1:])), shape)
        elif k.endswith("weight") and v.ndim == 1:
            a = rng.uniform(0.2, 0.5, shape) if ".bn3." in k else rng.uniform(0.5, 1.2, shape)
        else:
            a = rng.normal(0, 0.1 if v.ndim == 1 else 0.02, shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    model.load_state_dict(sd)
    return model, sd


def _chain_b(sd, **kw):
    p, s = torchvision_resnet50_to_flax(sd, **kw)
    return _flax_to_state_dict({"params": p, "batch_stats": s})


def _assert_bit_equal(a: dict, b: dict):
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:8]
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("sum_conv1", [False, True], ids=["rgb", "depth_summed"])
def test_converter_bit_equal_to_jax_chain(tv, sum_conv1):
    _, sd = tv
    a = pc.resnet50_from_torchvision(sd, sum_conv1_to_1ch=sum_conv1)
    _assert_bit_equal(a, _chain_b(sd, sum_conv1_to_1ch=sum_conv1))
    ResNet50(in_channels=1 if sum_conv1 else 3).load_state_dict(a, strict=True)
    if sum_conv1:
        assert a["conv1.weight"].shape == (64, 1, 7, 7)


def test_converter_with_prefix_bit_equal(tv):
    _, sd = tv
    wrapped = {f"backbone.0.{k}": v for k, v in sd.items()}
    a = pc.resnet50_from_torchvision(wrapped, prefix="backbone.0.")
    _assert_bit_equal(a, _chain_b(wrapped, prefix="backbone.0."))
    _assert_bit_equal(a, pc.resnet50_from_torchvision(sd))


def test_tower_forward_matches_torch_reference(tv):
    model, sd = tv
    x = np.random.default_rng(6).standard_normal((2, S, S, 3)).astype(np.float32)
    with torch.no_grad():
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        t = model.maxpool(model.relu(model.bn1(model.conv1(t))))
        t = model.layer4(model.layer3(model.layer2(model.layer1(t))))
        want = torch.flatten(model.avgpool(t), 1).numpy()
        tower = ResNet50().eval()
        tower.load_state_dict(pc.resnet50_from_torchvision(sd), strict=True)
        got = tower(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= 1e-5


def test_s2d_weights_bit_equal_to_jax():
    w7 = np.random.default_rng(7).standard_normal((64, 3, 7, 7)).astype(np.float32)
    got = pc.s2d_conv1_weights(torch.from_numpy(w7)).numpy()
    want = j_s2d(w7.transpose(2, 3, 1, 0)).transpose(3, 2, 0, 1)
    assert got.shape == (64, 12, 4, 4) and np.array_equal(got, want)
    with pytest.raises(ValueError):
        pc.s2d_conv1_weights(torch.zeros(64, 3, 5, 5))


def test_s2d_stem_matches_7x7_and_jax(tv):
    _, sd = tv
    state = pc.resnet50_from_torchvision(sd)
    s2d_state = dict(state, **{"conv1.weight": pc.s2d_conv1_weights(state["conv1.weight"])})
    plain = ResNet50().eval()
    plain.load_state_dict(state, strict=True)
    s2d = ResNet50(stem_s2d=True).eval()
    s2d.load_state_dict(s2d_state, strict=True)
    x = np.random.default_rng(8).standard_normal((2, S, S, 3)).astype(np.float32)
    with torch.no_grad():
        got = s2d(torch.from_numpy(x)).numpy()
        ref = plain(torch.from_numpy(x)).numpy()
    assert _rel(got, ref) <= 1e-5

    p, s = torchvision_resnet50_to_flax(sd)
    p["conv1"]["kernel"] = j_s2d(p["conv1"]["kernel"])
    want = JResNet50(stem_space_to_depth=True).apply({"params": p, "batch_stats": s},
                                                      jnp.asarray(x))
    assert _rel(got, want) <= 1e-4
    # the JAX tree carries across with the [4, 4, 4C, O] conv1
    _assert_bit_equal(_flax_to_state_dict({"params": p, "batch_stats": s}), s2d_state)


def test_load_torch_state_dict_unwraps(tmp_path, tv):
    _, sd = tv
    for wrap in (None, "state_dict", "model_state_dict", "model"):
        path = tmp_path / f"{wrap}.pth"
        torch.save(sd if wrap is None else {wrap: sd, "epoch": 3}, path)
        got = pc.load_torch_state_dict(str(path))
        assert set(got) == set(sd) and torch.equal(got["conv1.weight"], sd["conv1.weight"])
