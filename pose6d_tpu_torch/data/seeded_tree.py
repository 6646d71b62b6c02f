"""A seeded LineMOD tree written fast and without cv2 or yaml, for the
smoke run and the request trace: frames of smooth seeded colour blocks with
the object's box filled in, a depth plane inside the box, gt.yml / info.yml
in LineMOD's flow-list form and ASCII PLY cubes. The JAX generator's
counterpart (data/synthetic.py) renders real poses; this one only has to be
read back by the port's parsers and loaders, at LineMOD's frame size.
"""

from __future__ import annotations

import os
import statistics
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

LINEMOD_K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                      [0.0, 0.0, 1.0]], np.float32)
FRAME_HW = (480, 640)
# LineMOD folder -> (cube half-extent in mm, mesh vertices); 10 is the eggbox (ADD-S)
OBJECTS = {1: (40.0, 800), 10: (55.0, 700)}


def seeded_frame(rng, bbox, z_mm: float, color, hw=FRAME_HW):
    """A smooth seeded RGB frame (32 px blocks plus a gradient) with the
    object's box filled in its colour, and uint16 depth in mm inside the
    box (a plane around z_mm), 0 outside."""
    h_img, w_img = hw
    coarse = rng.integers(30, 200, (h_img // 32 + 1, w_img // 32 + 1, 3))
    img = np.repeat(np.repeat(coarse, 32, 0), 32, 1)[:h_img, :w_img]
    img = img + (np.arange(w_img)[None, :, None] // 40)
    x, y, w, h = bbox
    img[y:y + h, x:x + w] = np.asarray(color) + rng.integers(0, 24, (h, w, 3))
    depth = np.zeros((h_img, w_img), np.uint16)
    tilt = rng.uniform(-0.3, 0.3, 2)
    yy, xx = np.mgrid[0:h, 0:w]
    depth[y:y + h, x:x + w] = (z_mm + tilt[0] * (xx - w / 2) + tilt[1] * (yy - h / 2)).astype(np.uint16)
    return np.clip(img, 0, 255).astype(np.uint8), depth


def write_linemod_tree(root: str, rng, objects: dict = OBJECTS, frames: int = 160,
                       depth: bool = True, hw=FRAME_HW) -> dict:
    """A seeded LineMOD tree under root: data/<NN>/rgb/NNNN.png and, with
    depth, data/<NN>/depth/NNNN.png (`frames` frames of hw in each folder
    of `objects`, encode_png), gt.yml and info.yml in LineMOD's flow-list
    form, and models/obj_NN.ply (ASCII, the object's vertex count in its
    cube) with models_info.yml. The draws are the same with or without
    depth. Box sides are 60-200 px at 640x480, scaled down with smaller
    frames. Every PNG written is read back by data/png.py and must equal its
    array bit for bit (ValueError if not). Returns {"data", "models",
    "frames", "decode_ms": the decode times, ms per frame}."""
    from .png import encode_png, read_png

    h_img, w_img = hw
    # box sides of 60-200 px at LineMOD's 640x480, scaled to smaller frames
    scale = min(h_img / FRAME_HW[0], w_img / FRAME_HW[1], 1.0)
    side = (max(4, round(60 * scale)), max(5, round(200 * scale)))
    data, models = os.path.join(root, "data"), os.path.join(root, "models")
    os.makedirs(models, exist_ok=True)
    info_lines, written = [], []
    for obj, (half, n_pts) in objects.items():
        pts = rng.uniform(-half, half, (n_pts, 3))
        with open(os.path.join(models, f"obj_{obj:02d}.ply"), "w") as f:
            f.write(f"ply\nformat ascii 1.0\nelement vertex {len(pts)}\nproperty float x\n"
                    f"property float y\nproperty float z\nend_header\n")
            f.writelines(f"{a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in pts)
        info_lines.append(f"{obj}: {{diameter: {2 * half * np.sqrt(3):.6f}, "
                          f"min_x: {-half}, size_x: {2 * half}}}\n")
        base = os.path.join(data, f"{obj:02d}")
        for sub in ("rgb", "depth") if depth else ("rgb",):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        color = rng.integers(60, 230, 3)
        gt, info = [], []
        for frame in range(frames):
            wh = rng.integers(*side, 2)
            xy = (rng.uniform(0, 1, 2) * (np.array([w_img, h_img]) - wh)).astype(int)
            bbox = [int(xy[0]), int(xy[1]), int(wh[0]), int(wh[1])]
            q = rng.normal(size=4)
            x, y, z, w = q / np.linalg.norm(q)
            rot = [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                   2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                   2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]
            t = [rng.uniform(-100, 100), rng.uniform(-100, 100), rng.uniform(600, 1000)]
            rgb, depth_mm = seeded_frame(rng, bbox, t[2], color, hw)
            name = f"{frame:04d}.png"
            written.append((os.path.join(base, "rgb", name), rgb))
            if depth:
                written.append((os.path.join(base, "depth", name), depth_mm))
            gt.append(f"{frame}:\n- cam_R_m2c: {[float(v) for v in rot]}\n"
                      f"  cam_t_m2c: {[float(v) for v in t]}\n  obj_bb: {bbox}\n"
                      f"  obj_id: {obj}\n")
            info.append(f"{frame}:\n  cam_K: {[float(v) for v in LINEMOD_K.ravel()]}\n"
                        f"  depth_scale: 1.0\n")
        with open(os.path.join(base, "gt.yml"), "w") as f:
            f.writelines(gt)
        with open(os.path.join(base, "info.yml"), "w") as f:
            f.writelines(info)
    with open(os.path.join(models, "models_info.yml"), "w") as f:
        f.writelines(info_lines)

    def write(item):
        with open(item[0], "wb") as f:
            f.write(encode_png(item[1]))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, written))
    times = {"rgb": [], "depth": []}
    for path, arr in written:
        t0 = time.perf_counter()
        got = read_png(path)
        times["rgb" if arr.ndim == 3 else "depth"].append((time.perf_counter() - t0) * 1e3)
        if got.dtype != arr.dtype or not np.array_equal(got, arr):
            raise ValueError(f"{path} does not decode to the array written")
    return {"data": data, "models": models, "frames": len(times["rgb"]),
            "decode_ms": {k: statistics.median(v) for k, v in times.items() if v}}
