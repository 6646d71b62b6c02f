"""Synthetic LineMOD-format dataset generator (counterpart of
pose6d_tpu/data/synthetic.py), without cv2.

Writes a small, geometrically consistent tree in LineMOD's on-disk layout
(data/{NN}/{rgb,depth}/*.png + gt.yml + info.yml, and models/obj_NN.ply +
models_info.yml). Objects are coloured cuboids drawn as filled projected
silhouettes with their 12 edges and 8 corners marked in fixed colours;
depth maps carry the object's Z over its silhouette; boxes are the
projected corners' extents.

The numpy draws are the JAX generator's, in the same order, so a seed gives
the same poses, colours, point clouds and background noise; the
annotations and PLY files are the same text. The drawing is data/raster.py
(OpenCV's integer algorithms in numpy) and the PNGs are written by
data/png.py, in place of cv2.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..geometry.pinhole import DEFAULT_K
from . import raster
from .png import read_png, write_png


def _write_ply(path: str, pts_mm: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts_mm)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in pts_mm:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


# 20 well-separated marker colours (12 edges + 8 corners), fixed across
# frames so that the pose can be read from the appearance
MARKER_COLORS = [
    (255, 40, 40), (40, 255, 40), (40, 40, 255), (255, 255, 40),
    (255, 40, 255), (40, 255, 255), (255, 140, 0), (140, 255, 0),
    (0, 140, 255), (140, 0, 255), (255, 255, 255), (160, 160, 160),
    (200, 80, 80), (80, 200, 80), (80, 80, 200), (220, 220, 80),
    (220, 80, 220), (80, 220, 220), (240, 170, 90), (170, 90, 240),
]
# the cuboid's 12 edges: corner pairs differing in one coordinate
EDGES = [(a, b) for a in range(8) for b in range(a + 1, 8) if bin(a ^ b).count("1") == 1]


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    # QR of a Gaussian matrix, sign-fixed
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def _bounded_rotation(rng: np.random.Generator, max_angle_deg: float) -> np.ndarray:
    """A rotation about a random axis by an angle uniform in
    [0, max_angle_deg] (a bounded viewing range, as LineMOD's)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rng.uniform(0.0, max_angle_deg))
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def _symmetric_color_maps():
    """Marker-colour maps under which a cuboid looks the same after the
    object-frame symmetry R_z(180deg) (corner i -> i ^ 0b110): paired
    corners and edges share a colour, so only ADD-S scores the pose fairly,
    as for LineMOD's eggbox and glue."""
    sigma = lambda i: i ^ 0b110  # noqa: E731
    edge_color = []
    for ei, (a, b) in enumerate(EDGES):
        mate = EDGES.index(tuple(sorted((sigma(a), sigma(b)))))
        edge_color.append(min(ei, mate))
    corner_color = [min(ci, sigma(ci)) for ci in range(8)]
    return edge_color, corner_color


def _cuboid_corners(half_mm: float) -> np.ndarray:
    return (np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                     dtype=np.float64) * half_mm / 1000.0)


def _color_maps(obj_id: int, symmetric_obj_ids) -> tuple:
    if obj_id in symmetric_obj_ids:
        return _symmetric_color_maps()
    return list(range(12)), list(range(8))


def _draw_cuboid(rgb, depth, corners_m, K, color, edge_cmap, corner_cmap, R_m2c, t_m):
    """Draw one posed cuboid into rgb / depth in place and return its box
    [x, y, w, h]: the silhouette (the projected corners' convex hull), the
    edges far to near (2 px), the corner dots (radius 4), and the depth
    (mm) over the silhouette. No random draws."""
    cam_pts = corners_m @ R_m2c.T + t_m
    z = np.clip(cam_pts[:, 2], 1e-3, None)
    u = cam_pts[:, 0] * K[0, 0] / z + K[0, 2]
    v = cam_pts[:, 1] * K[1, 1] / z + K[1, 2]

    x0, x1p = int(np.floor(u.min())), int(np.ceil(u.max()))
    y0, y1p = int(np.floor(v.min())), int(np.ceil(v.max()))
    bbox = [x0, y0, x1p - x0, y1p - y0]

    hull = raster.convex_hull(np.stack([u, v], axis=1).astype(np.int32))
    raster.fill_convex_poly(rgb, hull, color)
    order = np.argsort(-(z[[a for a, _ in EDGES]] + z[[b for _, b in EDGES]]))
    for ei in order:
        a, b = EDGES[ei]
        raster.line(rgb, (int(u[a]), int(v[a])), (int(u[b]), int(v[b])),
                    MARKER_COLORS[edge_cmap[ei]], 2)
    for ci in np.argsort(-z):
        raster.circle_filled(rgb, (int(u[ci]), int(v[ci])), 4, MARKER_COLORS[12 + corner_cmap[ci]])

    mask = np.zeros(depth.shape, dtype=np.uint8)
    raster.fill_convex_poly(mask, hull, 1)
    depth[mask > 0] = int(t_m[2] * 1000.0)
    return bbox


def _render_frame(rng, corners_m, K, color, edge_cmap, corner_cmap, img_w, img_h,
                  max_angle_deg, R_m2c=None, t_m=None):
    """One frame (rgb uint8, depth uint16 mm, bbox, R, t) at a random pose,
    or at the one given; the draws are the JAX generator's."""
    if R_m2c is None:
        R_m2c = (_bounded_rotation(rng, max_angle_deg) if max_angle_deg > 0
                 else _random_rotation(rng))
    if t_m is None:
        t_m = np.array([rng.uniform(-0.08, 0.08), rng.uniform(-0.06, 0.06),
                        rng.uniform(0.6, 1.1)])
    rgb = rng.integers(0, 60, size=(img_h, img_w, 3), dtype=np.uint8)
    depth = np.zeros((img_h, img_w), dtype=np.uint16)
    bbox = _draw_cuboid(rgb, depth, corners_m, K, color, edge_cmap, corner_cmap, R_m2c, t_m)
    return rgb, depth, bbox, R_m2c, t_m


def _merge_models_info(model_dir: str, info_lines: list) -> None:
    """Write info_lines into models_info.yml, keeping the other ids already
    there (a tree can be extended by later calls)."""
    info_path = os.path.join(model_dir, "models_info.yml")
    merged = {}
    if os.path.exists(info_path):
        with open(info_path) as f:
            for line in f:
                if ":" in line:
                    merged[int(line.split(":")[0])] = line
    for line in info_lines:
        merged[int(line.split(":")[0])] = line
    with open(info_path, "w") as f:
        f.writelines(merged[k] for k in sorted(merged))


PNG_BATCH = 64  # images held before they are written


def _write_pngs(items) -> None:
    """write_png over (path, image) pairs, on threads: zlib releases the GIL."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(lambda item: write_png(*item), items))


def generate_synthetic_linemod(root: str, obj_ids: tuple = (1, 2), frames_per_obj: int = 20,
                               img_w: int = 640, img_h: int = 480, seed: int = 0,
                               max_angle_deg: float = 0.0,
                               symmetric_obj_ids: tuple = (10, 11)) -> dict:
    """Write a synthetic tree under `root`; returns {"data", "models"}.

    max_angle_deg > 0 bounds the rotations to a ball of that angle about
    the identity (0: uniform rotations). Folders in symmetric_obj_ids (by
    default 10 and 11, LineMOD's eggbox and glue) are drawn with the
    180-degree-symmetric marker colours. A later call with other obj_ids
    under the same root adds their folders and merges models_info.yml."""
    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "data")
    model_dir = os.path.join(root, "models")
    os.makedirs(model_dir, exist_ok=True)
    K = DEFAULT_K

    info_lines = []
    for obj_id in obj_ids:
        # the size follows the folder id, so that a folder keeps its
        # geometry when a tree is extended
        half_mm = 35.0 + 12.0 * ((obj_id - 1) % 8)
        pts_mm = rng.uniform(-half_mm, half_mm, size=(800, 3))
        _write_ply(os.path.join(model_dir, f"obj_{obj_id:02d}.ply"), pts_mm)
        diameter_mm = 2.0 * half_mm * np.sqrt(3.0)
        info_lines.append(f"{obj_id}: {{diameter: {diameter_mm:.3f}}}\n")

        obj_dir = os.path.join(data_dir, f"{obj_id:02d}")
        rgb_dir = os.path.join(obj_dir, "rgb")
        depth_dir = os.path.join(obj_dir, "depth")
        os.makedirs(rgb_dir, exist_ok=True)
        os.makedirs(depth_dir, exist_ok=True)
        corners_m = _cuboid_corners(half_mm)

        gt_entries, info_entries = [], []
        color = tuple(int(c) for c in rng.integers(80, 255, size=3))
        edge_cmap, corner_cmap = _color_maps(obj_id, symmetric_obj_ids)
        pngs = []
        for frame in range(frames_per_obj):
            rgb, depth, bbox, R_m2c, t_m = _render_frame(
                rng, corners_m, K, color, edge_cmap, corner_cmap, img_w, img_h, max_angle_deg)
            pngs += [(os.path.join(rgb_dir, f"{frame:04d}.png"), rgb),
                     (os.path.join(depth_dir, f"{frame:04d}.png"), depth)]
            if len(pngs) >= PNG_BATCH:
                _write_pngs(pngs)
                pngs = []
            gt_entries.append((frame, R_m2c.flatten().tolist(), (t_m * 1000.0).tolist(), bbox,
                               obj_id))
            info_entries.append((frame, K.flatten().tolist()))
        _write_pngs(pngs)

        with open(os.path.join(obj_dir, "gt.yml"), "w") as f:
            for frame, rmat, tmm, bbox, oid in gt_entries:
                f.write(f"{frame}:\n")
                f.write(f"- cam_R_m2c: {rmat}\n")
                f.write(f"  cam_t_m2c: {tmm}\n")
                f.write(f"  obj_bb: {bbox}\n")
                f.write(f"  obj_id: {oid}\n")
        with open(os.path.join(obj_dir, "info.yml"), "w") as f:
            for frame, kflat in info_entries:
                f.write(f"{frame}:\n")
                f.write(f"  cam_K: {kflat}\n")
                f.write("  depth_scale: 1.0\n")

    _merge_models_info(model_dir, info_lines)
    return {"data": data_dir, "models": model_dir}


def recover_object_colors(data_dir: str) -> dict:
    """Each object folder's silhouette colour, read from its first frame:
    the most frequent colour whose channels are all >= 80 that is not a
    marker colour (background noise is < 60 in every channel).
    Returns {obj_id (folder number): (r, g, b)}."""
    marker = {tuple(c) for c in MARKER_COLORS}
    colors = {}
    for folder in sorted(os.listdir(data_dir)):
        rgb_dir = os.path.join(data_dir, folder, "rgb")
        if not (folder.isdigit() and os.path.isdir(rgb_dir)):
            continue
        img = read_png(os.path.join(rgb_dir, sorted(os.listdir(rgb_dir))[0]))
        cand = img[(img >= 80).all(axis=-1)]
        vals, counts = np.unique(cand.reshape(-1, 3), axis=0, return_counts=True)
        for i in np.argsort(-counts):
            c = tuple(int(v) for v in vals[i])
            if c not in marker:
                colors[int(folder)] = c
                break
    return colors


def generate_synthetic_scene(root: str, object_colors: dict, frames: int = 20,
                             img_w: int = 640, img_h: int = 480, seed: int = 7,
                             max_angle_deg: float = 0.0, scene_folder: int = 1,
                             symmetric_obj_ids: tuple = (10, 11),
                             write_models: bool = True) -> dict:
    """Write multi-object frames in LineMOD's layout: one data/<scene_folder>
    tree whose gt.yml lists every object of every frame (as LineMOD's
    folder 02 does), for build_frame_index and eval_e2e --max-objects.

    object_colors {obj_id: (r, g, b)}, e.g. recover_object_colors of a
    single-object tree, keeps the appearances a detector was trained on;
    the geometry follows obj_id as in generate_synthetic_linemod. Each
    frame draws all objects far to near, each in its own jittered cell of a
    translation grid. write_models writes fresh point clouds and
    models_info.yml under root/models."""
    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "data")
    model_dir = os.path.join(root, "models")
    obj_ids = sorted(object_colors)

    obj_dir = os.path.join(data_dir, f"{scene_folder:02d}")
    rgb_dir = os.path.join(obj_dir, "rgb")
    depth_dir = os.path.join(obj_dir, "depth")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(depth_dir, exist_ok=True)

    K = DEFAULT_K
    specs = {}
    info_lines = []
    for obj_id in obj_ids:
        half_mm = 35.0 + 12.0 * ((obj_id - 1) % 8)
        specs[obj_id] = (_cuboid_corners(half_mm),) + tuple(_color_maps(obj_id,
                                                                         symmetric_obj_ids))
        if write_models:
            os.makedirs(model_dir, exist_ok=True)
            pts_mm = rng.uniform(-half_mm, half_mm, size=(800, 3))
            _write_ply(os.path.join(model_dir, f"obj_{obj_id:02d}.ply"), pts_mm)
            diameter_mm = 2.0 * half_mm * np.sqrt(3.0)
            info_lines.append(f"{obj_id}: {{diameter: {diameter_mm:.3f}}}\n")

    # the translation grid: one cell per object, shuffled per frame
    n = len(obj_ids)
    gx = int(np.ceil(np.sqrt(n)))
    gy = int(np.ceil(n / gx))
    xs = np.linspace(-0.13, 0.13, gx) if gx > 1 else np.zeros(1)
    ys = np.linspace(-0.10, 0.10, gy) if gy > 1 else np.zeros(1)
    cells = [(x, y) for y in ys for x in xs]

    gt_yaml, info_yaml = [], []
    for frame in range(frames):
        rgb = rng.integers(0, 60, size=(img_h, img_w, 3), dtype=np.uint8)
        depth = np.zeros((img_h, img_w), dtype=np.uint16)
        order = rng.permutation(n)
        poses = []
        for slot, oi in enumerate(order):
            obj_id = obj_ids[oi]
            R_m2c = (_bounded_rotation(rng, max_angle_deg) if max_angle_deg > 0
                     else _random_rotation(rng))
            cx, cy = cells[slot]
            t_m = np.array([cx + rng.uniform(-0.02, 0.02), cy + rng.uniform(-0.02, 0.02),
                            rng.uniform(0.65, 1.1)])
            poses.append((obj_id, R_m2c, t_m))
        annos = []
        for obj_id, R_m2c, t_m in sorted(poses, key=lambda p: -p[2][2]):
            corners_m, edge_cmap, corner_cmap = specs[obj_id]
            bbox = _draw_cuboid(rgb, depth, corners_m, K, object_colors[obj_id], edge_cmap,
                                corner_cmap, R_m2c, t_m)
            annos.append((obj_id, R_m2c, t_m, bbox))
        write_png(os.path.join(rgb_dir, f"{frame:04d}.png"), rgb)
        write_png(os.path.join(depth_dir, f"{frame:04d}.png"), depth)

        gt_yaml.append(f"{frame}:\n")
        for obj_id, R_m2c, t_m, bbox in sorted(annos, key=lambda a: a[0]):
            gt_yaml.append(f"- cam_R_m2c: {R_m2c.flatten().tolist()}\n")
            gt_yaml.append(f"  cam_t_m2c: {(t_m * 1000.0).tolist()}\n")
            gt_yaml.append(f"  obj_bb: {bbox}\n")
            gt_yaml.append(f"  obj_id: {obj_id}\n")
        info_yaml.append(f"{frame}:\n")
        info_yaml.append(f"  cam_K: {K.flatten().tolist()}\n")
        info_yaml.append("  depth_scale: 1.0\n")

    with open(os.path.join(obj_dir, "gt.yml"), "w") as f:
        f.writelines(gt_yaml)
    with open(os.path.join(obj_dir, "info.yml"), "w") as f:
        f.writelines(info_yaml)
    if write_models:
        _merge_models_info(model_dir, info_lines)
    return {"data": data_dir, "models": model_dir}
