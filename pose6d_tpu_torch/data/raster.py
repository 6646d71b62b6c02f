"""Integer rasterizers in numpy for the drawing the JAX package does with
cv2 (the synthetic LineMOD generator and the overlays of utils/viz.py;
the card's machine has no cv2).

They follow the integer algorithms of OpenCV's drawing code for 8-connected
lines (imgproc/drawing.cpp): a convex polygon filled by scanlines between
two edge walkers in 16.16 fixed point, its outline drawn over it; a
Bresenham line; a filled midpoint circle; a thick line (first clipped to
the image grown by its thickness) as a filled quadrilateral 1/2 of its
thickness to each side, with round caps; and the convex hull of integer
points. tests/test_torch_synthetic.py holds them to cv2 pixel for pixel. Every function draws in place into an
[H, W] or [H, W, C] array with a colour of C channel values.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    """Pixels x1..x2 (inclusive, clipped to the image) of row y."""
    if 0 <= y < img.shape[0]:
        x1, x2 = max(x1, 0), min(x2, img.shape[1] - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = color


def _clip_line(w: int, h: int, p1: list, p2: list) -> bool:
    """Clip the segment p1-p2 (lists [x, y], changed in place) to the
    rectangle [0, w-1] x [0, h-1]; False when it lies outside."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:], p2[:] = [x1, y1], [x2, y2]
    return (c1 | c2) == 0


def line8(img: np.ndarray, pt1, pt2, color) -> None:
    """A 1-px 8-connected line between integer points (Bresenham, walked
    left to right)."""
    p1, p2 = [int(pt1[0]), int(pt1[1])], [int(pt2[0]), int(pt2[1])]
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        if not _clip_line(w, h, p1, p2):
            return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    plus, minus = 2 * dx, -2 * dy
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = color
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:  # the major axis is y
            y += sy
            x += sx if step else 0
        else:
            x += sx
            y += sy if step else 0


def _line_fixed(img: np.ndarray, pt1, pt2, color) -> None:
    """A 1-px line between 16.16 fixed-point points (the outline of a
    polygon drawn at sub-pixel precision)."""
    h, w = img.shape[:2]
    p1, p2 = [int(pt1[0]), int(pt1[1])], [int(pt2[0]), int(pt2[1])]
    if not _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2):
        return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            p1, p2 = p2, p1
            dy = -dy
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (p2[0] - p1[0]) >> XY_SHIFT
    else:
        if dy < 0:
            p1, p2 = p2, p1
            dx = -dx
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (p2[1] - p1[1]) >> XY_SHIFT
    x, y = p1[0] + (XY_ONE >> 1), p1[1] + (XY_ONE >> 1)
    _put(img, (p2[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p2[1] + (XY_ONE >> 1)) >> XY_SHIFT, color)
    if ax > ay:
        x >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x, y >> XY_SHIFT, color)
            x += 1
            y += y_step
            ecount -= 1
    else:
        y >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x >> XY_SHIFT, y, color)
            x += x_step
            y += 1
            ecount -= 1


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_convex_poly(img: np.ndarray, pts, color, shift: int = 0) -> None:
    """Fill the convex polygon of integer vertices `pts` [N, 2] (fixed point
    with `shift` fractional bits), outline included."""
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    n = len(v)
    if n == 0:
        return
    h, w = img.shape[:2]
    delta = (1 << shift) >> 1
    # the outline, 8-connected
    p0 = v[-1]
    for p in v:
        if shift == 0:
            line8(img, p0, p, color)
        else:
            _line_fixed(img, (p0[0] << (XY_SHIFT - shift), p0[1] << (XY_SHIFT - shift)),
                        (p[0] << (XY_SHIFT - shift), p[1] << (XY_SHIFT - shift)), color)
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    imin = min(range(n), key=lambda i: (ys[i], i))
    xmin, xmax = (min(xs) + delta) >> shift, (max(xs) + delta) >> shift
    ymin, ymax = (min(ys) + delta) >> shift, (max(ys) + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # two edge walkers from the top vertex, one each way round
    e_idx, e_di = [imin, imin], [1, n - 1]
    e_x, e_dx, e_ye = [-XY_ONE, -XY_ONE], [0, 0], [ymin, ymin]
    edges = n
    half = XY_ONE >> 1
    y = ymin
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0 = e_idx[i]
                idx = (idx0 + e_di[i]) % n
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs0 = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e_ye[i] = ty
                        e_dx[i] = _tdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y))
                        e_x[i] = xs0
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx = (idx + e_di[i]) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            x1 = (e_x[left] + half) >> XY_SHIFT
            x2 = (e_x[right] + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                _hline(img, y, x1, x2, color)
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def circle_filled(img: np.ndarray, center, radius: int, color) -> None:
    """A filled midpoint circle of integer `radius` about an integer centre."""
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, x1, x2 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            _hline(img, yy, x1, x2, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int, flags: int) -> None:
    """A line of `thickness` > 1 between integer points: the quadrilateral
    thickness/2 to each side, and round caps at the ends flagged by bit 0
    (p0) and bit 1 (p1)."""
    p0 = (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT)
    p1 = (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx, dpy = _round(dy * r), _round(dx * r)
        quad = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        fill_convex_poly(img, quad, color, shift=XY_SHIFT)
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            center = ((p[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p[1] + (XY_ONE >> 1)) >> XY_SHIFT)
            circle_filled(img, center, (t + (XY_ONE >> 1)) >> XY_SHIFT, color)


def _round(x: float) -> int:
    """Round half to even, as the C library's lrint."""
    return int(np.rint(x))


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> None:
    """A line between integer points, 8-connected at thickness 1, else a
    thick line with round caps."""
    if thickness <= 1:
        line8(img, pt1, pt2, color)
        return
    # a segment that leaves the image grown by `thickness` on each side is
    # first clipped to that rectangle, its integer end points moved onto it
    t = thickness
    p1, p2 = [int(pt1[0]) + t, int(pt1[1]) + t], [int(pt2[0]) + t, int(pt2[1]) + t]
    h, w = img.shape[:2]
    if not _clip_line(w + 2 * t, h + 2 * t, p1, p2):
        return
    _thick_line(img, (p1[0] - t, p1[1] - t), (p2[0] - t, p2[1] - t), color, thickness, 3)


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> None:
    """The outline of the axis-aligned rectangle with corners pt1, pt2."""
    (x1, y1), (x2, y2) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    flags = 2  # a closed polyline: a cap at each corner, drawn once
    p0 = corners[-1]
    for p in corners:
        if thickness <= 1:
            line8(img, p0, p, color)
        else:
            _thick_line(img, p0, p, color, thickness, flags)
        p0 = p


def convex_hull(points) -> np.ndarray:
    """The convex hull of integer points [N, 2] as [M, 2] int32 vertices,
    collinear points dropped (Andrew's monotone chain)."""
    pts = sorted({(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)})
    if len(pts) <= 2:
        return np.asarray(pts, np.int32).reshape(-1, 2)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1], np.int32)

