"""Host-side input pipeline (counterpart of pose6d_tpu/data/pipeline.py):
PNG decode and crop on CPU threads; augmentation runs on the card inside
the train step (ops/augment.train_augment).

One loader gives the superset of fields; each variant's step picks what it
consumes:
  rgb          [B, S, S, 3] float32 in [0, 1] (uint8 with compact_arrays)
  depth        [B, S, S, 1] float32 normalized (rgbd flavour)
  depth_raw    [B, S, S]    float32 metres (compact: 'depth_mm' uint16)
  quat         [B, 4] xyzw, trans [B, 3] metres, obj_id [B] int32
  center_orig  [B, 2] original-frame box centre, cam_K [B, 3, 3]
  center_crop  [B, 2] the centre in the resized crop, cam_K_crop [B, 3, 3]
  valid        [B] bool, False on the padding of a last short batch

Decoding goes through data/png.py and the crop through data/crop.py
(cv2's arithmetic without cv2); the random draws are the JAX loader's, in
its order: the epoch's shuffle, one `integers` per batch for the samples'
seeds, then default_rng(seed) per sample for the bbox jitter. The same
seed gives the same batches.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from .crop import (JITTER, adjust_K_for_crop, compute_crop_params, crop_resize_image,
                   jitter_bbox, normalize_depth_np)
from .device_pipeline import quat_from_matrix
from .linemod import Sample, build_index
from .png import read_depth, read_png


class LineMODPoseLoader:
    """Index once; decode and crop per batch on a thread pool.

    flavor 'rgb' or 'rgbd' sets the jitter (JITTER) and whether depth is
    read; augment_bbox defaults to mode == 'train'; cache_decoded keeps
    every decoded frame in RAM (LineMOD-scale: ~1.7 GB RGB, 0.6 GB depth);
    compact_arrays emits rgb as uint8 and depth as uint16 'depth_mm', which
    the train step expands on the card (train.loop.decompress_batch)."""

    def __init__(self, data_root: str, mode: str = "train", flavor: str = "rgb",
                 img_size: int = 224, augment_bbox: Optional[bool] = None,
                 num_workers: int = 8, cache_decoded: bool = False,
                 compact_arrays: bool = False):
        if flavor not in JITTER:
            raise ValueError(f"flavor must be one of {sorted(JITTER)}, got {flavor!r}")
        self.compact_arrays = compact_arrays
        self.flavor = flavor
        self.img_size = img_size
        self.mode = mode
        self.augment_bbox = (mode == "train") if augment_bbox is None else augment_bbox
        self.with_depth = flavor == "rgbd"
        self.cache_decoded = cache_decoded
        self._decoded: Dict[str, np.ndarray] = {}
        self.samples = build_index(data_root, mode=mode, require_depth=self.with_depth)
        self._pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers > 0 else None
        # one batch in flight ahead of the consumer; a separate executor,
        # since make_batch fans out into _pool
        self._prefetch = ThreadPoolExecutor(max_workers=1) if num_workers > 0 else None

    def __len__(self) -> int:
        return len(self.samples)

    def close(self) -> None:
        """Stop the loader's threads."""
        for pool in (self._pool, self._prefetch):
            if pool is not None:
                pool.shutdown(wait=True)

    def _decode(self, path: str, depth_shape=None) -> np.ndarray:
        if self.cache_decoded and path in self._decoded:
            return self._decoded[path]
        img = read_png(path) if depth_shape is None else read_depth(path, depth_shape)
        if self.cache_decoded:
            self._decoded[path] = img
        return img

    def load_sample(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        s: Sample = self.samples[idx]
        rgb_image = self._decode(s.img_path)
        h_img, w_img = rgb_image.shape[:2]
        bbox = s.bbox
        bbox_j = jitter_bbox(bbox, rng, *JITTER[self.flavor]) if self.augment_bbox else bbox
        p = compute_crop_params(bbox_j, bbox, w_img, h_img, self.img_size)
        rgb_crop = crop_resize_image(rgb_image, p)
        out: Dict[str, np.ndarray] = {
            "rgb": rgb_crop if self.compact_arrays else rgb_crop.astype(np.float32) / 255.0,
            "quat": quat_from_matrix(s.rot_mat[None])[0].astype(np.float32),
            "trans": (s.trans_mm / 1000.0).astype(np.float32),
            "obj_id": np.int32(s.obj_id),
            "center_orig": np.asarray(p.center_orig, dtype=np.float32),
            "cam_K": s.cam_K.astype(np.float32),
            "center_crop": np.asarray(p.center_crop, dtype=np.float32),
            "cam_K_crop": adjust_K_for_crop(s.cam_K, p),
        }
        if self.with_depth:
            depth_image = (self._decode(s.depth_path, (h_img, w_img)) if s.depth_path
                           else np.zeros((h_img, w_img), dtype=np.uint16))
            depth_crop = crop_resize_image(depth_image, p)
            if self.compact_arrays:
                out["depth_mm"] = depth_crop
            else:
                depth_raw_m = depth_crop.astype(np.float32) / 1000.0
                out["depth_raw"] = depth_raw_m
                out["depth"] = normalize_depth_np(depth_raw_m)[..., None]
        return out

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle: bool = True,
                drop_remainder: bool = True,
                rows: Optional[slice] = None) -> Iterator[Dict[str, np.ndarray]]:
        """Stacked fixed-shape batches. With drop_remainder a last short
        batch is dropped (train); otherwise it is padded by repeating its
        last sample and 'valid' marks the real rows (eval).

        rows (a rank's parallel.local_rows under a mesh) loads and crops
        only those rows of each global batch. The shuffle and the samples'
        seeds are still drawn for the whole global batch, so the rows are
        those of the unsliced batch, jitter included, and rng ends where
        it would without rows."""
        order = np.arange(len(self.samples))
        if shuffle:
            rng.shuffle(order)

        def make_batch(idxs, n_valid):
            seeds = rng.integers(0, 2**31 - 1, size=len(idxs))
            valid = np.zeros(len(idxs), dtype=bool)
            valid[:n_valid] = True
            if rows is not None:
                idxs, seeds, valid = idxs[rows], seeds[rows], valid[rows]
            jobs = list(zip(idxs, seeds))
            load = lambda a: self.load_sample(a[0], np.random.default_rng(a[1]))  # noqa: E731
            items = list(self._pool.map(load, jobs)) if self._pool else [load(a) for a in jobs]
            batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
            batch["valid"] = valid
            return batch

        plan = []
        for start in range(0, len(order), batch_size):
            chunk = order[start:start + batch_size]
            if len(chunk) < batch_size:
                if drop_remainder:
                    break
                pad = np.full(batch_size - len(chunk), chunk[-1])
                plan.append((np.concatenate([chunk, pad]), len(chunk)))
            else:
                plan.append((chunk, len(chunk)))

        if self._prefetch is None:
            for c in plan:
                yield make_batch(*c)
            return
        # the 1-thread executor runs make_batch calls in order, so rng's
        # draws (and the jitter) do not depend on the prefetch
        fut = None
        for c in plan:
            nxt = self._prefetch.submit(make_batch, *c)
            if fut is not None:
                yield fut.result()
            fut = nxt
        if fut is not None:
            yield fut.result()
