"""The port's rotation pathway learns (tests/test_learning.py's test on
pose6d_tpu_torch): 60 optimizer steps of the rgb variant on one fixed batch
of 8 distinct rotations at img 64, lr 3e-4, augmentation off, every step
drawing from a generator seeded alike (JAX's fixed key). The total loss
must more than halve, and the geodesic distance after training must sit
far below the ~2.2 rad of random rotations: gradients turn the quaternion
head toward the labels, not only the translation's L1 down. f32 on the
CPU; the same test at 224, in f32 and bf16, is chip_smoke's learning
phase."""

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from pose6d_tpu_torch.geometry.quat import quat_normalize
from pose6d_tpu_torch.losses.pose_loss import geodesic_distance
from pose6d_tpu_torch.ops.augment import AugmentConfig, eval_preprocess
from pose6d_tpu_torch.train.loop import TrainConfig, create_train_state, make_train_step
from torch_port_utils import few_torch_threads  # noqa: F401

B, S, STEPS = 8, 64, 60


def test_rotation_overfits_one_batch():
    rng = np.random.default_rng(0)
    cfg = TrainConfig(variant="rgb", img_size=S, batch_size=B, learning_rate=3e-4,
                      augment=AugmentConfig(brightness=0.0, contrast=0.0, saturation=0.0,
                                            hue=0.0, grayscale_p=0.0, erase_p=0.0))
    state = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg)
    batch = {
        "rgb": rng.uniform(0, 1, size=(B, S, S, 3)).astype(np.float32),
        "quat": R.random(B, random_state=1).as_quat().astype(np.float32),
        "trans": np.tile(np.array([[0, 0, 0.8]], np.float32), (B, 1)),
        "obj_id": np.zeros(B, np.int32),
        "valid": np.ones(B, bool),
    }
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch, torch.Generator().manual_seed(42))
        losses.append(float(m["loss"]))

    assert np.isfinite(losses).all(), losses
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])

    state.model.eval()
    with torch.no_grad():
        pred_rot, _ = state.model(rgb=eval_preprocess(torch.from_numpy(batch["rgb"])))
    geo = float(geodesic_distance(pred_rot, quat_normalize(torch.from_numpy(batch["quat"]))))
    # chance is ~2.2 rad; memorizing 8 rotations must land far below it
    assert geo < 1.6, geo
