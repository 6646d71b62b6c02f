"""Device-resident training input (counterpart of
pose6d_tpu/data/device_pipeline.py): a split's frames live on the card,
crops are two matmuls per batch.

  - the decoded split (uint8 RGB [N, H, W, 3], uint16 depth in mm
    [N, H, W]) goes to the card once, packed on the host into 32-bit words
    [N, R] with one frame per row (ops/gather_frames.pack_frames_host);
  - per step the host does scalar work only: sample indices, bbox jitter
    and the crop bookkeeping, in vectorised float64 numpy with the scalar
    contract's int() truncations;
  - the train step gathers the batch's frames by index (the gather kernel)
    and crops them (train/loop.expand_device_batch).

`DeviceFrameStore` is built from arrays. Building it from a LineMOD split
on disk (cv2 decoding through the host loader) is not ported.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..ops.gather_frames import pack_frames_host
from .crop import CROP_EXPANSION, JITTER


def _vector_crop_params(bbox_j: np.ndarray, bbox_orig: np.ndarray, img_w: int,
                        img_h: int, img_size: int) -> Dict[str, np.ndarray]:
    """The crop bookkeeping of a batch of jittered boxes bbox_j [B, 4] (xywh,
    float64) around the original boxes bbox_orig [B, 4].

    Crop origins are in the original frame and may be negative (the device
    crop reads outside the frame as the reference's zero padding); x1, y1
    and size truncate toward zero as int() does."""
    x, y, w, h = bbox_j.T
    xo, yo, wo, ho = bbox_orig.T
    c_x, c_y = x + w / 2.0, y + h / 2.0
    size_f = np.maximum(w, h) * CROP_EXPANSION
    x1 = np.trunc(c_x - size_f / 2.0)
    y1 = np.trunc(c_y - size_f / 2.0)
    size = np.trunc(size_f)
    pad_l = np.maximum(0.0, -x1)
    pad_t = np.maximum(0.0, -y1)
    scale = np.where(size > 0, img_size / np.maximum(size, 1.0), 0.0)
    center_orig = np.stack([xo + wo / 2.0, yo + ho / 2.0], axis=-1)
    # the centre in resized-crop pixels: (cx + pad_l - x1_padded) * s, and
    # x1_padded = x1 + pad_l
    ccx = np.clip((center_orig[:, 0] - x1) * scale, 0, img_size - 1)
    ccy = np.clip((center_orig[:, 1] - y1) * scale, 0, img_size - 1)
    f32 = np.float32
    return {
        "x1": x1.astype(f32), "y1": y1.astype(f32), "size": size.astype(f32),
        "scale": scale.astype(f32), "pad_l": pad_l.astype(f32), "pad_t": pad_t.astype(f32),
        "center_orig": center_orig.astype(f32),
        "center_crop": np.stack([ccx, ccy], axis=-1).astype(f32),
    }


def _vector_adjust_K(cam_K: np.ndarray, p: Dict[str, np.ndarray]) -> np.ndarray:
    """Intrinsics of each crop [B, 3, 3]: fx' = fx s, cx' = (cx - x1) s with
    the original-frame x1 (the padding cancels)."""
    K = np.zeros((cam_K.shape[0], 3, 3), dtype=np.float32)
    s = p["scale"]
    K[:, 0, 0] = cam_K[:, 0, 0] * s
    K[:, 1, 1] = cam_K[:, 1, 1] * s
    K[:, 0, 2] = (cam_K[:, 0, 2] - p["x1"]) * s
    K[:, 1, 2] = (cam_K[:, 1, 2] - p["y1"]) * s
    K[:, 2, 2] = 1.0
    return K


def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrices [N, 3, 3] -> xyzw quaternions [N, 4] (float64),
    scipy's Rotation.from_matrix(m).as_quat(): matrices that are not
    orthogonal to 1e-12 are first projected (U V^T of their SVD); the
    largest of the diagonal and the trace picks the pivot."""
    m = np.array(m, dtype=np.float64)
    gram = m @ np.swapaxes(m, -1, -2)
    bad = ~np.all(np.isclose(gram, np.eye(3), atol=1e-12, rtol=1e-5), axis=(-2, -1))
    if bad.any():
        u, _, vt = np.linalg.svd(m[bad], full_matrices=False)
        m[bad] = u @ vt
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    choice = np.argmax(np.stack([m[:, 0, 0], m[:, 1, 1], m[:, 2, 2], tr], -1), -1)
    cands = np.stack([
        np.stack([1 - tr + 2 * m[:, 0, 0], m[:, 1, 0] + m[:, 0, 1],
                  m[:, 2, 0] + m[:, 0, 2], m[:, 2, 1] - m[:, 1, 2]], -1),
        np.stack([m[:, 1, 0] + m[:, 0, 1], 1 - tr + 2 * m[:, 1, 1],
                  m[:, 2, 1] + m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0]], -1),
        np.stack([m[:, 2, 0] + m[:, 0, 2], m[:, 2, 1] + m[:, 1, 2],
                  1 - tr + 2 * m[:, 2, 2], m[:, 1, 0] - m[:, 0, 1]], -1),
        np.stack([m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0],
                  m[:, 1, 0] - m[:, 0, 1], 1 + tr], -1),
    ], 1)
    q = cands[np.arange(len(m)), choice]
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


class DeviceFrameStore:
    """A split's frames on the card and its labels on the host; yields
    metadata-only batches (indices, crop scalars, labels) for the device
    train step (train.loop.make_train_step with device_preprocess=True).

    rgb [N, H, W, 3] uint8 and depth [N, H, W] uint16 millimetres (or None)
    are the decoded frames; bbox [N, 4] xywh pixels, rot_mat [N, 3, 3],
    trans_mm [N, 3], obj_id [N] and cam_K [N, 3, 3] the labels. Frames whose
    bytes are whole 128-word rows go to `device` as packed int32 words
    [N, R] (`rgb_packed` / `depth_packed`); others go raw (depth as an
    int16 view of the same bits, since torch's uint16 has few kernels)."""

    def __init__(self, rgb: np.ndarray, depth: Optional[np.ndarray], bbox: np.ndarray,
                 rot_mat: np.ndarray, trans_mm: np.ndarray, obj_id: np.ndarray,
                 cam_K: np.ndarray, *, img_size: int = 224, flavor: str = "rgb",
                 augment_bbox: bool = True, device=DEFAULT_DEVICE):
        if rgb.ndim != 4 or rgb.shape[-1] != 3 or rgb.dtype != np.uint8:
            raise ValueError(f"rgb must be [N, H, W, 3] uint8, got {rgb.shape} {rgb.dtype}")
        if len(rgb) == 0:
            raise ValueError("empty split")
        if depth is not None and (depth.shape != rgb.shape[:3] or depth.dtype != np.uint16):
            raise ValueError(f"depth must be [N, H, W] uint16, got {depth.shape} {depth.dtype}")
        if flavor not in JITTER:
            raise ValueError(f"flavor must be one of {sorted(JITTER)}, got {flavor!r}")
        self.img_size = img_size
        self.flavor = flavor
        self.augment_bbox = augment_bbox
        self.with_depth = depth is not None
        self.device = torch.device(device)
        self.frame_h, self.frame_w = rgb.shape[1:3]
        self.frame_shape = (self.frame_h, self.frame_w, 3)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        words = pack_frames_host(rgb)
        self.rgb_packed = words is not None
        self.rgb_frames = put(words.view(np.int32) if self.rgb_packed else rgb)
        self.depth_packed = False
        self.depth_frames = None
        if depth is not None:
            words = pack_frames_host(depth)
            self.depth_packed = words is not None
            self.depth_frames = put(words.view(np.int32) if self.depth_packed
                                    else depth.view(np.int16))

        n = len(rgb)
        self._bbox = np.asarray(bbox, np.float64).reshape(n, 4)
        self._quat = quat_from_matrix(np.asarray(rot_mat).reshape(n, 3, 3)).astype(np.float32)
        self._trans = (np.asarray(trans_mm, np.float64).reshape(n, 3) / 1000.0).astype(np.float32)
        self._obj_id = np.asarray(obj_id, np.int32).reshape(n)
        self._cam_K = np.asarray(cam_K, np.float32).reshape(n, 3, 3)

    def __len__(self) -> int:
        return len(self._bbox)

    def nbytes(self) -> int:
        n = self.rgb_frames.numel() * self.rgb_frames.element_size()
        if self.depth_frames is not None:
            n += self.depth_frames.numel() * self.depth_frames.element_size()
        return int(n)

    def meta_batch(self, idxs: np.ndarray, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Host-side scalar work for one batch: jitter + crop bookkeeping."""
        bbox = self._bbox[idxs]
        if self.augment_bbox:
            pos, sc = JITTER[self.flavor]
            B = len(idxs)
            w, h = bbox[:, 2], bbox[:, 3]
            # the per-component int() truncation of the scalar jitter
            jx = np.trunc(rng.uniform(-pos, pos, B) * w)
            jy = np.trunc(rng.uniform(-pos, pos, B) * h)
            sw = np.trunc(rng.uniform(-sc, sc, B) * w)
            sh = np.trunc(rng.uniform(-sc, sc, B) * h)
            bbox_j = np.stack([bbox[:, 0] + jx, bbox[:, 1] + jy, w + sw, h + sh], axis=-1)
        else:
            bbox_j = bbox
        p = _vector_crop_params(bbox_j, bbox, self.frame_w, self.frame_h, self.img_size)
        return {
            "idx": idxs.astype(np.int32),
            "x1": p["x1"],
            "y1": p["y1"],
            "size": p["size"],
            "quat": self._quat[idxs],
            "trans": self._trans[idxs],
            "obj_id": self._obj_id[idxs],
            "center_orig": p["center_orig"],
            "cam_K": self._cam_K[idxs],
            "center_crop": p["center_crop"],
            "cam_K_crop": _vector_adjust_K(self._cam_K[idxs], p),
        }

    def epoch_meta(self, batch_size: int, rng: np.random.Generator, shuffle: bool = True):
        """The whole epoch's metadata stacked into [n_steps, B, ...] arrays
        for train.loop.make_train_epoch, and n_steps; (None, 0) when the
        split holds less than one batch."""
        batches = [{k: v for k, v in b.items() if k != "valid"}
                   for b in self.batches(batch_size, rng, shuffle=shuffle, drop_remainder=True)]
        if not batches:
            return None, 0
        return {k: np.stack([b[k] for b in batches]) for k in batches[0]}, len(batches)

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Metadata batches over the split in (shuffled) order; a last short
        batch is dropped, or padded by repeating its last index with
        "valid" False on the padding."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        n = len(order)
        for start in range(0, n, batch_size):
            chunk = order[start:start + batch_size]
            n_valid = len(chunk)
            if n_valid < batch_size:
                if drop_remainder:
                    break
                chunk = np.concatenate([chunk, np.full(batch_size - n_valid, chunk[-1])])
            batch = self.meta_batch(chunk, rng)
            valid = np.zeros(batch_size, dtype=bool)
            valid[:n_valid] = True
            batch["valid"] = valid
            yield batch
