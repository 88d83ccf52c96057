"""Image post-processing geometry (the port of ``rten_tpu/imageproc.py``):
contours, polygon algorithms, drawing.

Analog of rten-imageproc (contours.rs, poly_algos.rs, shapes.rs,
drawing.rs, normalize.rs). Geometry stays on the host: numpy, and the
native C++ core (``native/imageproc.cpp``) for contour tracing and NMS,
which run natively unless the caller passes ``native=False`` (a native
core that cannot be built raises). ``normalize_image`` runs on the
tensor's own device. Points are (row, col) like the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import native as _native
from .runtime.executor import resolve_device

Point = Tuple[int, int]  # (y, x)


@dataclasses.dataclass(frozen=True)
class Rect:
    top: int
    left: int
    bottom: int
    right: int

    @property
    def height(self) -> int:
        return self.bottom - self.top

    @property
    def width(self) -> int:
        return self.right - self.left

    @property
    def area(self) -> int:
        return max(self.height, 0) * max(self.width, 0)

    def intersects(self, o: "Rect") -> bool:
        return (
            self.left < o.right and o.left < self.right
            and self.top < o.bottom and o.top < self.bottom
        )

    def intersection(self, o: "Rect") -> "Rect":
        return Rect(
            max(self.top, o.top), max(self.left, o.left),
            min(self.bottom, o.bottom), min(self.right, o.right),
        )

    def union(self, o: "Rect") -> "Rect":
        return Rect(
            min(self.top, o.top), min(self.left, o.left),
            max(self.bottom, o.bottom), max(self.right, o.right),
        )

    def iou(self, o: "Rect") -> float:
        if not self.intersects(o):
            return 0.0
        inter = self.intersection(o).area
        return inter / (self.area + o.area - inter)


# --- contours (Moore-neighbor border following, rten contours.rs) ----------

_NEIGHBORS = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]


def find_contours(mask: np.ndarray, mode: str = "external",
                  native: bool = True) -> List[np.ndarray]:
    """Trace outer borders of connected foreground regions.

    mask: 2D array, nonzero = foreground. Returns a list of [N, 2] (y, x)
    border point arrays, one per connected component (8-connectivity).
    mode: 'external' only (outer borders), like the common OCR usage of the
    reference (rten-imageproc/src/contours.rs). Runs the C++ tracer
    (native/imageproc.cpp) unless ``native`` is False; this Python version
    is then the one that runs, and the tests' golden.
    """
    if native:
        return _native.find_contours(np.asarray(mask))
    grid = (np.asarray(mask) != 0).astype(np.int8)
    H, W = grid.shape
    visited = np.zeros_like(grid, dtype=bool)
    contours = []
    padded = np.pad(grid, 1)

    for y in range(H):
        for x in range(W):
            if grid[y, x] == 0 or visited[y, x]:
                continue
            # Border start: foreground with background to the left.
            if x > 0 and grid[y, x - 1] != 0:
                if visited[y, x - 1]:
                    visited[y, x] = True  # interior of a known run
                continue
            # Moore boundary tracing from (y, x), entering from the left.
            start = (y, x)
            contour = [start]
            visited[y, x] = True
            prev_dir = 6  # came from the west
            cur = start
            while True:
                found = False
                for k in range(8):
                    d = (prev_dir + 1 + k) % 8
                    dy, dx = _NEIGHBORS[d]
                    ny, nx = cur[0] + dy, cur[1] + dx
                    if padded[ny + 1, nx + 1]:
                        if (ny, nx) == start and len(contour) > 1:
                            found = True
                            cur = None
                            break
                        contour.append((ny, nx))
                        visited[ny, nx] = True
                        cur = (ny, nx)
                        prev_dir = (d + 4) % 8
                        found = True
                        break
                if not found or cur is None:
                    break
            contours.append(np.asarray(contour, np.int32))
            # Mark the whole component as visited (flood fill) so inner
            # pixels don't re-trigger.
            _flood_mark(grid, visited, y, x)
    return contours


def _flood_mark(grid, visited, y, x):
    stack = [(y, x)]
    H, W = grid.shape
    while stack:
        cy, cx = stack.pop()
        if cy < 0 or cy >= H or cx < 0 or cx >= W:
            continue
        if grid[cy, cx] == 0 or visited[cy, cx] and (cy, cx) != (y, x):
            if not (cy == y and cx == x):
                continue
        if visited[cy, cx] and (cy, cx) != (y, x):
            continue
        visited[cy, cx] = True
        for dy, dx in _NEIGHBORS:
            ny, nx = cy + dy, cx + dx
            if 0 <= ny < H and 0 <= nx < W and grid[ny, nx] and not visited[ny, nx]:
                stack.append((ny, nx))


def bounding_rect(points: np.ndarray) -> Rect:
    p = np.asarray(points)
    return Rect(
        int(p[:, 0].min()), int(p[:, 1].min()),
        int(p[:, 0].max()) + 1, int(p[:, 1].max()) + 1,
    )


# --- polygon algorithms (rten poly_algos.rs) --------------------------------


def polygon_area(points: np.ndarray) -> float:
    """Shoelace area (points [N,2] in (y,x) order)."""
    p = np.asarray(points, np.float64)
    y, x = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def simplify_polygon(points: np.ndarray, epsilon: float) -> np.ndarray:
    """Douglas-Peucker simplification."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n < 3:
        return np.asarray(points)
    keep = np.zeros(n, bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        a, z = stack.pop()
        if z <= a + 1:
            continue
        seg = pts[z] - pts[a]
        seg_len = np.hypot(*seg)
        if seg_len == 0:
            d = np.hypot(*(pts[a + 1 : z] - pts[a]).T)
        else:
            rel = pts[a + 1 : z] - pts[a]
            d = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / seg_len  # 2-D cross
        imax = int(np.argmax(d))
        if d[imax] > epsilon:
            keep[a + 1 + imax] = True
            stack.append((a, a + 1 + imax))
            stack.append((a + 1 + imax, z))
    return np.asarray(points)[keep]


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; returns hull in counter-clockwise order."""
    pts = sorted({(float(p[0]), float(p[1])) for p in np.asarray(points)})
    if len(pts) <= 2:
        return np.asarray(pts)

    def cross(o, a, b):
        return (a[1] - o[1]) * (b[0] - o[0]) - (a[0] - o[0]) * (b[1] - o[1])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1])


def min_area_rect(points: np.ndarray) -> np.ndarray:
    """Minimum-area oriented bounding rect via rotating calipers.

    Returns 4 corners [(y, x); 4] (rten poly_algos.rs min_area_rect).
    """
    hull = convex_hull(points)
    if len(hull) <= 2:
        r = bounding_rect(np.asarray(points))
        return np.asarray(
            [(r.top, r.left), (r.top, r.right - 1), (r.bottom - 1, r.right - 1),
             (r.bottom - 1, r.left)], np.float64,
        )
    best = None
    best_area = np.inf
    n = len(hull)
    for i in range(n):
        edge = hull[(i + 1) % n] - hull[i]
        norm = np.hypot(*edge)
        if norm == 0:
            continue
        ux = edge / norm          # unit along edge
        uy = np.asarray([-ux[1], ux[0]])  # perpendicular
        proj_x = (hull - hull[i]) @ ux
        proj_y = (hull - hull[i]) @ uy
        w = proj_x.max() - proj_x.min()
        h = proj_y.max() - proj_y.min()
        area = w * h
        if area < best_area:
            best_area = area
            origin = hull[i] + ux * proj_x.min() + uy * proj_y.min()
            best = np.asarray(
                [origin, origin + ux * w, origin + ux * w + uy * h, origin + uy * h]
            )
    return best


# --- drawing (rten drawing.rs) ---------------------------------------------


def draw_line(img: np.ndarray, p0: Point, p1: Point, value) -> None:
    """Bresenham line on a 2D (or [C,H,W] with broadcast value) image."""
    y0, x0 = int(p0[0]), int(p0[1])
    y1, x1 = int(p1[0]), int(p1[1])
    dy = abs(y1 - y0)
    dx = abs(x1 - x0)
    sy = 1 if y0 < y1 else -1
    sx = 1 if x0 < x1 else -1
    err = dx - dy
    H, W = img.shape[-2:]
    while True:
        if 0 <= y0 < H and 0 <= x0 < W:
            img[..., y0, x0] = value
        if y0 == y1 and x0 == x1:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x0 += sx
        if e2 < dx:
            err += dx
            y0 += sy


def draw_polygon(img: np.ndarray, points, value) -> None:
    pts = np.asarray(points)
    for i in range(len(pts)):
        draw_line(img, pts[i], pts[(i + 1) % len(pts)], value)


def fill_rect(img: np.ndarray, rect: Rect, value) -> None:
    img[..., max(rect.top, 0): rect.bottom, max(rect.left, 0): rect.right] = value


def normalize_image(img, mean: Sequence[float], std: Sequence[float],
                    device=None) -> torch.Tensor:
    """[C,H,W] float image -> (img - mean) / std per channel in f32
    (rten normalize.rs), on the image's device where it is a tensor, else
    on ``device`` (the card unless the caller names another)."""
    if not isinstance(img, torch.Tensor):
        img = torch.as_tensor(np.asarray(img, np.float32), device=resolve_device(device))
    img = img.to(torch.float32)

    def per_channel(v):
        return torch.as_tensor(np.asarray(v, np.float32).reshape(-1, 1, 1), device=img.device)

    return (img - per_channel(mean)) / per_channel(std)


# --- shapes: Line / RotatedRect (rten shapes.rs Line :?, RotatedRect) -------


@dataclasses.dataclass(frozen=True)
class Line:
    """Line segment between two (y, x) points (rten shapes.rs Line)."""

    start: Tuple[float, float]
    end: Tuple[float, float]

    @property
    def length(self) -> float:
        dy = self.end[0] - self.start[0]
        dx = self.end[1] - self.start[1]
        return float(np.hypot(dy, dx))

    def is_horizontal(self) -> bool:
        return self.start[0] == self.end[0]

    def intersects(self, other: "Line") -> bool:
        """Segment intersection via orientation tests."""

        def orient(a, b, c):
            v = (b[1] - a[1]) * (c[0] - a[0]) - (b[0] - a[0]) * (c[1] - a[1])
            return 0 if v == 0 else (1 if v > 0 else -1)

        def on_seg(a, b, c):
            return (
                min(a[0], b[0]) <= c[0] <= max(a[0], b[0])
                and min(a[1], b[1]) <= c[1] <= max(a[1], b[1])
            )

        p1, p2, p3, p4 = self.start, self.end, other.start, other.end
        d1 = orient(p3, p4, p1)
        d2 = orient(p3, p4, p2)
        d3 = orient(p1, p2, p3)
        d4 = orient(p1, p2, p4)
        if d1 != d2 and d3 != d4:
            return True
        return (
            (d1 == 0 and on_seg(p3, p4, p1))
            or (d2 == 0 and on_seg(p3, p4, p2))
            or (d3 == 0 and on_seg(p1, p2, p3))
            or (d4 == 0 and on_seg(p1, p2, p4))
        )

    def distance_to_point(self, p: Tuple[float, float]) -> float:
        a = np.asarray(self.start, float)
        b = np.asarray(self.end, float)
        c = np.asarray(p, float)
        ab = b - a
        denom = float(ab @ ab)
        t = 0.0 if denom == 0 else float(np.clip((c - a) @ ab / denom, 0, 1))
        return float(np.linalg.norm(a + t * ab - c))


@dataclasses.dataclass(frozen=True)
class RotatedRect:
    """Oriented rectangle: center (y, x), (height, width), angle radians
    (rten shapes.rs RotatedRect; min_area_rect returns its corners)."""

    center: Tuple[float, float]
    size: Tuple[float, float]
    angle: float

    @property
    def area(self) -> float:
        return float(self.size[0] * self.size[1])

    def corners(self) -> np.ndarray:
        """[4, 2] (y, x) corners, counter-clockwise."""
        cy, cx = self.center
        h, w = self.size
        c, s = np.cos(self.angle), np.sin(self.angle)
        # axis vectors: 'width' axis rotated by angle in (y, x) coords
        ux = np.array([s, c])   # unit vector along width
        uy = np.array([c, -s])  # unit vector along height
        ctr = np.array([cy, cx])
        half_w = ux * (w / 2)
        half_h = uy * (h / 2)
        return np.stack([
            ctr - half_w - half_h,
            ctr + half_w - half_h,
            ctr + half_w + half_h,
            ctr - half_w + half_h,
        ])

    def bounding_rect(self) -> Rect:
        cs = self.corners()
        return Rect(
            int(np.floor(cs[:, 0].min())), int(np.floor(cs[:, 1].min())),
            int(np.ceil(cs[:, 0].max())), int(np.ceil(cs[:, 1].max())),
        )

    def scaled(self, factor: float) -> "RotatedRect":
        return RotatedRect(
            self.center, (self.size[0] * factor, self.size[1] * factor),
            self.angle,
        )

    @staticmethod
    def from_points(points: np.ndarray) -> "RotatedRect":
        """Minimum-area oriented rect of a point set (rotating calipers,
        built on min_area_rect's corner output)."""
        corners = min_area_rect(points)
        center = corners.mean(axis=0)
        e0 = corners[1] - corners[0]
        e1 = corners[2] - corners[1]
        w = float(np.linalg.norm(e0))
        h = float(np.linalg.norm(e1))
        angle = float(np.arctan2(e0[0], e0[1]))
        return RotatedRect((float(center[0]), float(center[1])), (h, w), angle)


def fill_polygon(img: np.ndarray, points, value) -> None:
    """Scanline polygon fill (rten drawing.rs FillIter): points [N, 2] (y, x)."""
    pts = np.asarray(points, float)
    n = len(pts)
    if n < 3:
        return
    y0 = max(0, int(np.floor(pts[:, 0].min())))
    y1 = min(img.shape[0] - 1, int(np.ceil(pts[:, 0].max())))
    for y in range(y0, y1 + 1):
        yc = y + 0.5
        xs = []
        for i in range(n):
            ay, ax = pts[i]
            by, bx = pts[(i + 1) % n]
            if (ay <= yc < by) or (by <= yc < ay):
                t = (yc - ay) / (by - ay)
                xs.append(ax + t * (bx - ax))
        xs.sort()
        for j in range(0, len(xs) - 1, 2):
            x0 = max(0, int(np.ceil(xs[j] - 0.5)))
            x1 = min(img.shape[1] - 1, int(np.floor(xs[j + 1] - 0.5)))
            if x1 >= x0:
                img[y, x0 : x1 + 1] = value


def draw_rect(img: np.ndarray, rect: Rect, value) -> None:
    """Stroke an axis-aligned rect outline."""
    t = max(rect.top, 0)
    l = max(rect.left, 0)
    b = min(rect.bottom, img.shape[0] - 1)
    r = min(rect.right, img.shape[1] - 1)
    if b < t or r < l:
        return
    img[t, l : r + 1] = value
    img[b, l : r + 1] = value
    img[t : b + 1, l] = value
    img[t : b + 1, r] = value


def nms_boxes(
    boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.45,
    score_threshold: float = 0.0, max_detections: int = 300, native: bool = True,
) -> List[int]:
    """Greedy per-class-agnostic NMS over [N, 4] (top,left,bottom,right)
    boxes; returns kept indices sorted by score (host-side postprocessing
    companion to the NonMaxSuppression op). The C++ core unless ``native``
    is False."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    if native:
        return _native.nms(boxes, scores, iou_threshold, score_threshold, max_detections)
    keep: List[int] = []
    order = np.argsort(-scores, kind="stable")
    order = order[scores[order] > score_threshold]
    rects = [Rect(*[float(c) for c in b]) for b in boxes]
    for i in order:
        ri = rects[i]
        if all(ri.iou(rects[j]) <= iou_threshold for j in keep):
            keep.append(int(i))
            if len(keep) >= max_detections:
                break
    return keep
