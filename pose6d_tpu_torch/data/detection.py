"""Detection data (counterpart of pose6d_tpu/data/detection.py): the YOLO
export of a LineMOD tree and the letterboxing detection loader, without
yaml or cv2 (the card's machine has neither).

  1. `prepare_yolo_dataset`: the reference's scripts/setup/prepare_yolo.py
     tree (images/{split}, labels/{split} with normalised cx cy w h, and
     dataset.yaml), byte for byte as the JAX package writes it.
  2. `DetectionLoader`: letterboxed uint8 frames and padded gt boxes from
     the LineMOD tree, for models/yolo/train.DetectionTrainer.

gt.yml goes through the port's C++ parser (data/_native.parse_gt), the
PNGs through data/png.py (RGB, where cv2 reads BGR and the JAX loader
converts), and cv2's INTER_LINEAR resize is data/crop.resize_linear, equal
to it bit for bit on uint8. Class ids follow the reference: the index of
the object's folder in the sorted folder list (prepare_yolo.py:67), not
obj_id - 1 (LineMOD has no folders 03 and 07, so folder 04 is class 2).
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np

from . import _native
from .crop import resize_linear
from .linemod import split_of_index
from .png import png_size, read_png


def convert_bbox_to_yolo(size: Tuple[int, int], box) -> Tuple[float, float, float, float]:
    """Absolute xywh -> normalised cx cy w h (prepare_yolo.py:29-35)."""
    dw = 1.0 / size[0]
    dh = 1.0 / size[1]
    return ((box[0] + box[2] / 2.0) * dw, (box[1] + box[3] / 2.0) * dh, box[2] * dw, box[3] * dh)


def _annotated_folders(root: str) -> Iterator[Tuple[str, str, dict, List[str]]]:
    """(folder, rgb dir, parsed gt.yml, sorted PNG names) of every numeric
    folder of root that has both rgb/ and gt.yml, in sorted order."""
    for folder in sorted(f for f in os.listdir(root) if f.isdigit()):
        rgb_dir = os.path.join(root, folder, "rgb")
        gt_path = os.path.join(root, folder, "gt.yml")
        if not (os.path.isdir(rgb_dir) and os.path.exists(gt_path)):
            continue
        images = sorted(i for i in os.listdir(rgb_dir) if i.endswith(".png"))
        yield folder, rgb_dir, _native.parse_gt(gt_path), images


def _scan_detection_samples(source_root: str) -> Tuple[List[dict], List[str]]:
    """One annotation per image: the folder's own object (prepare_yolo.py:93-97)."""
    obj_folders = [f for f in sorted(os.listdir(source_root)) if f.isdigit()]
    samples = []
    for folder, rgb_dir, gts, images in _annotated_folders(source_root):
        for i, img_name in enumerate(images):
            frame_id = int(img_name.split(".")[0])
            anno = next((a for a in gts.get(frame_id, ())
                         if str(int(a["obj_id"])).zfill(2) == folder), None)
            if anno is None:
                continue
            samples.append({"img_path": os.path.join(rgb_dir, img_name), "folder": folder,
                            "class_id": obj_folders.index(folder),
                            "bbox": np.asarray(anno["obj_bb"], np.float32),
                            "split": split_of_index(i), "name": f"{folder}_{img_name}"})
    return samples, obj_folders


def _scan_scene_samples(scene_root: str, class_names: List[str], max_gt: int) -> List[dict]:
    """Per-frame samples of a multi-object scene tree (one folder whose
    gt.yml lists every object of each frame): each annotation whose obj_id
    is among class_names (the single-object tree's sorted folders) fills
    one gt slot, up to max_gt; frames keep the index-based split."""
    samples: List[dict] = []
    for folder, rgb_dir, gts, images in _annotated_folders(scene_root):
        for i, img_name in enumerate(images):
            frame_id = int(img_name.split(".")[0])
            annos = []
            for a in gts.get(frame_id, ()):
                key = str(int(a["obj_id"])).zfill(2)
                if key in class_names:
                    annos.append((np.asarray(a["obj_bb"], np.float32), class_names.index(key)))
            if not annos:
                continue
            samples.append({"img_path": os.path.join(rgb_dir, img_name), "folder": folder,
                            "annos": annos[:max_gt], "split": split_of_index(i),
                            "name": f"scene{folder}_{img_name}"})
    return samples


def prepare_yolo_dataset(source_root: str, dest_root: str) -> dict:
    """Write the YOLO-format tree under dest_root (removed first). Returns
    the per-split counts."""
    if os.path.exists(dest_root):
        shutil.rmtree(dest_root)
    for split in ("train", "val", "test"):
        os.makedirs(os.path.join(dest_root, "images", split), exist_ok=True)
        os.makedirs(os.path.join(dest_root, "labels", split), exist_ok=True)

    samples, obj_folders = _scan_detection_samples(source_root)
    stats = {"train": 0, "val": 0, "test": 0}
    for s in samples:
        split = s["split"]
        shutil.copy(s["img_path"], os.path.join(dest_root, "images", split, s["name"]))
        label = os.path.join(dest_root, "labels", split, s["name"].replace(".png", ".txt"))
        cx, cy, bw, bh = convert_bbox_to_yolo(png_size(s["img_path"]), s["bbox"])
        with open(label, "w") as f:
            f.write(f"{s['class_id']} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}\n")
        stats[split] += 1

    with open(os.path.join(dest_root, "dataset.yaml"), "w") as f:
        f.write(f"path: {os.path.abspath(dest_root)} \n"
                "train: images/train\nval: images/val\ntest: images/test\n\n"
                f"nc: {len(obj_folders)}\nnames: {obj_folders}\n")
    return stats


def letterbox_params(w: int, h: int, target: int) -> Tuple[float, int, int]:
    """Scale and top/left padding of a centred letterbox into target x target."""
    scale = min(target / w, target / h)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    return scale, (target - nw) // 2, (target - nh) // 2


class DetectionLoader:
    """LineMOD -> letterboxed detection batches: "image" [B, S, S, 3] uint8
    (114 gray around the frame), "gt_boxes" [B, max_gt, 4] xyxy pixels on
    the canvas, "gt_labels" [B, max_gt] int32, "gt_mask" [B, max_gt],
    "valid" [B]. One batch is built ahead on a thread while the caller
    runs the last one."""

    def __init__(self, source_root: str, mode: str = "train", img_size: int = 640,
                 max_gt: int = 8, scene_roots: Tuple[str, ...] = ()):
        samples, obj_folders = _scan_detection_samples(source_root)
        self.samples = [s for s in samples if s["split"] == mode]
        self.class_names = obj_folders
        # multi-object scene frames join with the source_root's class ids
        for root in scene_roots:
            self.samples += [s for s in _scan_scene_samples(root, obj_folders, max_gt)
                             if s["split"] == mode]
        self.num_classes = len(obj_folders)
        self.img_size = img_size
        self.max_gt = max_gt
        self._prefetch = ThreadPoolExecutor(max_workers=1)

    def close(self) -> None:
        self._prefetch.shutdown(wait=True)

    def __len__(self) -> int:
        return len(self.samples)

    def load_sample(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.samples[idx]
        rgb = read_png(s["img_path"])
        h, w = rgb.shape[:2]
        scale, pad_l, pad_t = letterbox_params(w, h, self.img_size)
        nw, nh = int(round(w * scale)), int(round(h * scale))
        canvas = np.full((self.img_size, self.img_size, 3), 114, np.uint8)
        canvas[pad_t:pad_t + nh, pad_l:pad_l + nw] = resize_linear(rgb, (nh, nw))

        annos = s.get("annos") or [(s["bbox"], s["class_id"])]
        gt_boxes = np.zeros((self.max_gt, 4), np.float32)
        gt_labels = np.zeros((self.max_gt,), np.int32)
        gt_mask = np.zeros((self.max_gt,), bool)
        for slot, (bbox, class_id) in enumerate(annos[:self.max_gt]):
            x, y, bw, bh = bbox
            gt_boxes[slot] = (x * scale + pad_l, y * scale + pad_t,
                              (x + bw) * scale + pad_l, (y + bh) * scale + pad_t)
            gt_labels[slot] = class_id
            gt_mask[slot] = True
        return {"image": canvas, "gt_boxes": gt_boxes, "gt_labels": gt_labels, "gt_mask": gt_mask}

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """The split's batches in one pass; shuffled by rng as the JAX loader
        shuffles it. A last short batch is dropped, or padded with repeats
        of its last sample and marked by "valid"."""
        order = np.arange(len(self.samples))
        if shuffle:
            rng.shuffle(order)

        def make_batch(chunk, n_valid):
            items = [self.load_sample(int(i)) for i in chunk]
            batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
            valid = np.zeros(batch_size, bool)
            valid[:n_valid] = True
            batch["valid"] = valid
            return batch

        plan = []
        for start in range(0, len(order), batch_size):
            chunk = order[start:start + batch_size]
            n_valid = len(chunk)
            if n_valid < batch_size:
                if drop_remainder:
                    break
                chunk = np.concatenate([chunk, np.full(batch_size - n_valid, chunk[-1])])
            plan.append((chunk, n_valid))

        fut = None
        for c in plan:
            nxt = self._prefetch.submit(make_batch, *c)
            if fut is not None:
                yield fut.result()
            fut = nxt
        if fut is not None:
            yield fut.result()
