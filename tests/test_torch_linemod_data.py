"""The port's LineMOD reading without cv2 or yaml against the JAX package
and its oracles: the C++ gt.yml / info.yml parser (data/_native.py) equal
to pose6d_tpu.data._native and to yaml.safe_load, numbers exact; the PNG
reader (data/png.py) bit-equal to cv2.imread(IMREAD_UNCHANGED), RGB
channel-reversed, on cv2-written files (the generator's and the
multi-object tree parity/synth_scene_tr_a), PIL-written files and files
encoded here with each of the five row filters forced, for 8-bit RGB and
16-bit grey at odd widths; unsupported PNGs raise; build_index and
build_frame_index equal to JAX's field by field."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import yaml
from PIL import Image

from pose6d_tpu.data import _native as jnative
from pose6d_tpu.data import linemod as jlinemod
from pose6d_tpu.data.synthetic import generate_synthetic_linemod
from pose6d_tpu_torch.data import _native as tnative
from pose6d_tpu_torch.data import linemod as tlinemod
from pose6d_tpu_torch.data.png import decode_png, read_depth, read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "parity", "synth_scene_tr_a", "data")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("linemod_tree")
    return generate_synthetic_linemod(str(root), obj_ids=(1, 10), frames_per_obj=20,
                                      img_w=160, img_h=120, seed=4)


def _yaml(path):
    with open(path) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("where", ["generated", "scene"])
def test_parse_gt_and_info_exact(tree, where):
    base = os.path.join(tree["data"], "10") if where == "generated" else os.path.join(SCENE, "01")
    gt_path, info_path = os.path.join(base, "gt.yml"), os.path.join(base, "info.yml")
    got_gt, want_gt = tnative.parse_gt(gt_path), _yaml(gt_path)
    assert got_gt == jnative.parse_gt(gt_path)
    assert set(got_gt) == set(want_gt)
    for frame, annos in want_gt.items():
        assert len(got_gt[frame]) == len(annos)
        for a, b in zip(got_gt[frame], annos):
            assert a == {"obj_id": b["obj_id"], "obj_bb": [float(v) for v in b["obj_bb"]],
                         "cam_R_m2c": b["cam_R_m2c"], "cam_t_m2c": b["cam_t_m2c"]}
    if where == "scene":  # the multi-object gt.yml
        assert max(len(v) for v in got_gt.values()) > 1
    got_info = tnative.parse_info(info_path)
    assert got_info == jnative.parse_info(info_path) == _yaml(info_path)


def test_parser_wrapped_lists_and_bad_input(tmp_path):
    p = tmp_path / "gt.yml"
    p.write_text("3:\n- cam_R_m2c: [0.1, 0.2, 0.3,\n    0.4, 0.5, 0.6, 0.7,\n    0.8, 0.9]\n"
                 "  cam_t_m2c: [1.5, -2.25, 700.125]\n  obj_bb: [1, 2, 3, 4]\n  obj_id: 2\n")
    want = {3: [{"obj_id": 2, "obj_bb": [1.0, 2.0, 3.0, 4.0],
                 "cam_R_m2c": [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9],
                 "cam_t_m2c": [1.5, -2.25, 700.125]}]}
    assert tnative.parse_gt(str(p)) == want == _yaml(str(p))
    bad = tmp_path / "bad.yml"
    bad.write_text("0:\n- cam_R_m2c: [1, 2, 3]\n")  # 3 of 9 values
    with pytest.raises(ValueError, match="bad.yml"):
        tnative.parse_gt(str(bad))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No PyYAML fallback: a source g++ refuses raises with its output."""
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", str(src))
    monkeypatch.setattr(tnative, "LIB_PATH", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build()


# ------------------------------------------------------------------- PNG

def _cv2(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img[:, :, ::-1] if img.ndim == 3 else img


def _frames(data_dir, n):
    out = []
    for obj in sorted(os.listdir(data_dir)):
        for sub in ("rgb", "depth"):
            d = os.path.join(data_dir, obj, sub)
            out += [os.path.join(d, f) for f in sorted(os.listdir(d))[:n]]
    return out


@pytest.mark.parametrize("where", ["generated", "scene"])
def test_png_equals_cv2_on_cv2_files(tree, where):
    paths = _frames(tree["data"], 4) if where == "generated" else _frames(SCENE, 3)
    assert len(paths) >= 6
    for path in paths:
        got, want = read_png(path), _cv2(path)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


def test_png_equals_cv2_on_pil_files(tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    grey = rng.integers(0, 65536, (29, 51)).astype(np.uint16)
    Image.fromarray(rgb).save(tmp_path / "rgb.png")
    Image.fromarray(grey).save(tmp_path / "grey.png")  # mode I;16, big-endian in the file
    for name, arr in (("rgb.png", rgb), ("grey.png", grey)):
        path = str(tmp_path / name)
        assert np.array_equal(_cv2(path), arr)
        got = read_png(path)
        assert got.dtype == arr.dtype and np.array_equal(got, arr), name


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(body, zlib.crc32(kind)))


def encode_png(img, filters, depth=None, color=None, interlace=0, split_idat=False):
    """A PNG of img ([H, W, 3] uint8 or [H, W] uint16) whose row y uses
    filter filters[y % len(filters)], encoded by the PNG spec's formulas."""
    h, w = img.shape[:2]
    if img.dtype == np.uint8:
        bpp, d, c = 3, 8, 2
        rows = img.reshape(h, -1).astype(np.int64)
    else:
        bpp, d, c = 2, 16, 0
        rows = img.astype(">u2").view(np.uint8).reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        f = filters[y % len(filters)]
        x = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        up = rows[y - 1] if y else np.zeros_like(x)
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][f] if f < 5 else 0
        out.append(np.concatenate([[f], (x - pred) & 0xFF]))
    raw = zlib.compress(np.concatenate(out).astype(np.uint8).tobytes(), 6)
    idat = [raw[:len(raw) // 2], raw[len(raw) // 2:]] if split_idat else [raw]
    ihdr = struct.pack(">IIBBBBB", w, h, depth or d, c if color is None else color, 0, 0,
                       interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"gAMA", b"\x00\x00\xb1\x8f")
            + b"".join(_chunk(b"IDAT", part) for part in idat) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]])
@pytest.mark.parametrize("kind", ["rgb", "grey16"])
def test_png_each_filter(tmp_path, filters, kind):
    rng = np.random.default_rng(len(filters) * 7 + filters[0])
    if kind == "rgb":
        img = rng.integers(0, 256, (9, 37, 3), dtype=np.uint8)
    else:
        img = rng.integers(0, 65536, (11, 23)).astype(np.uint16)
    path = tmp_path / "f.png"
    path.write_bytes(encode_png(img, filters, split_idat=True))
    assert np.array_equal(_cv2(str(path)), img)
    got = read_png(str(path))
    assert got.dtype == img.dtype and np.array_equal(got, img)


def test_unsupported_pngs_raise(tmp_path):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    grey8 = rng.integers(0, 256, (6, 7), dtype=np.uint8)
    cases = {
        "interlaced.png": encode_png(rgb, [0], interlace=1),
        "grey8.png": encode_png(grey8[..., None].repeat(3, -1), [0], depth=8, color=0),
        "palette.png": encode_png(rgb, [0], color=3),
        "rgb16.png": encode_png(rgb, [0], depth=16),
        "badfilter.png": encode_png(rgb, [5]),
        "not.png": b"GIF89a",
    }
    crc = bytearray(encode_png(rgb, [1]))
    crc[40] ^= 0xFF  # inside the gAMA chunk
    cases["crc.png"] = bytes(crc)
    cases["truncated.png"] = encode_png(rgb, [1])[:-30]
    for name, data in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match=name):
            read_png(str(path))
    with pytest.raises(FileNotFoundError):
        read_png(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError):
        decode_png(b"\x89PNG\r\n\x1a\n")


def test_missing_depth_reads_as_zeros(tmp_path):
    """A missing depth file gives zeros, as the JAX loader does where
    cv2.imread returns None."""
    z = read_depth(str(tmp_path / "none.png"), (4, 5))
    assert z.dtype == np.uint16 and z.shape == (4, 5) and not z.any()
    assert not read_depth(None, (2, 3)).any()


# ----------------------------------------------------------------- index

def _assert_samples_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.img_path, a.depth_path, a.obj_id) == (b.img_path, b.depth_path, b.obj_id)
        for f in ("bbox", "rot_mat", "trans_mm", "cam_K"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("require_depth", [False, True])
def test_build_index_matches_jax(tree, mode, require_depth):
    _assert_samples_equal(tlinemod.build_index(tree["data"], mode, require_depth),
                          jlinemod.build_index(tree["data"], mode, require_depth))


@pytest.mark.parametrize("where", ["generated", "scene"])
def test_build_frame_index_matches_jax(tree, where):
    root = tree["data"] if where == "generated" else SCENE
    got = tlinemod.build_frame_index(root, "val")
    want = jlinemod.build_frame_index(root, "val")
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.img_path, a.depth_path) == (b.img_path, b.depth_path)
        assert np.array_equal(a.cam_K, b.cam_K)
        _assert_samples_equal(a.objects, b.objects)
    if where == "scene":
        assert max(len(f.objects) for f in got) > 1
    assert tlinemod.split_of_index(18) == "val" and tlinemod.split_of_index(29) == "test"
