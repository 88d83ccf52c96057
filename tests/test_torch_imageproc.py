"""The port's imageproc and imageio (``rten_tpu_torch/imageproc.py``,
``imageio.py``) against the JAX package's: the geometry on the host
equal (contours and NMS through the native core and through the Python
core, each equal to the JAX package's; polygon algorithms within 1e-9;
drawing exact), ``normalize_image`` on a tensor's device within 1e-6,
image conversion exact."""

import numpy as np
import pytest
import torch

from rten_tpu import imageio as jio
from rten_tpu import imageproc as jip
from rten_tpu_torch import imageio, imageproc as ip


def _masks():
    rng = np.random.default_rng(0)
    out = [(rng.random((40, 50)) > p).astype(np.uint8) for p in (0.4, 0.6, 0.8)]
    blobs = np.zeros((30, 30), np.uint8)
    blobs[2:7, 3:9] = 1
    blobs[12:25, 10:28] = 2
    blobs[15:20, 14:20] = 0  # a hole
    blobs[29, 0] = 1
    out += [blobs, np.ones((5, 7), np.uint8), np.zeros((4, 4), np.uint8), np.eye(9, dtype=np.uint8)]
    return out


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case", range(7))
def test_contours_match_jax(case, native):
    mask = _masks()[case]
    got = ip.find_contours(mask, native=native)
    want = jip.find_contours(mask)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert vars(ip.bounding_rect(a)) == vars(jip.bounding_rect(b))


def test_contour_buffers_grow():
    """The native tracer's point buffer starts at the mask's size plus 16
    and doubles when it fills: a one-pixel line is traced out and back,
    about two points a pixel."""
    mask = np.ones((1, 100), np.uint8)
    mask[0, [20, 50]] = 0
    got = ip.find_contours(mask)
    assert sum(len(c) for c in got) > mask.size + 16
    want = jip.find_contours(mask)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_nms_boxes_match_jax(native):
    rng = np.random.default_rng(1)
    for trial in range(6):
        n = 80
        tl = rng.random((n, 2)) * 80
        boxes = np.concatenate([tl, tl + rng.random((n, 2)) * 30 + 1], 1).astype(np.float32)
        scores = rng.random(n).astype(np.float32)
        scores[:10] = scores[10:20]  # ties keep the lower index first
        for iou, score, cap in ((0.45, 0.2, 300), (0.1, 0.0, 7), (0.9, 0.5, 300)):
            got = ip.nms_boxes(boxes, scores, iou, score, cap, native=native)
            assert got == jip.nms_boxes(boxes, scores, iou, score, cap), trial


def _same_value(a, b, tol=1e-9):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=tol, abs=tol)
    else:
        assert a == b


def test_polygon_algorithms_match_jax():
    rng = np.random.default_rng(2)
    for trial in range(10):
        pts = rng.integers(0, 50, (int(rng.integers(3, 40)), 2))
        for name, args in (("polygon_area", (pts,)), ("simplify_polygon", (pts, 2.5)),
                           ("convex_hull", (pts,)), ("min_area_rect", (pts,))):
            _same_value(getattr(ip, name)(*args), getattr(jip, name)(*args))
        r = ip.RotatedRect.from_points(pts)
        jr = jip.RotatedRect.from_points(pts)
        for attr in ("center", "size", "angle", "area"):
            _same_value(np.asarray(getattr(r, attr)), np.asarray(getattr(jr, attr)))
        _same_value(r.corners(), jr.corners())
        assert vars(r.bounding_rect()) == vars(jr.bounding_rect())
        assert vars(r.scaled(1.5)) == vars(jr.scaled(1.5))
    a, b = ip.Rect(0, 0, 10, 10), ip.Rect(5, 5, 15, 15)
    ja, jb = jip.Rect(0, 0, 10, 10), jip.Rect(5, 5, 15, 15)
    assert (a.area, a.intersects(b), a.iou(b), vars(a.union(b)), vars(a.intersection(b))) == \
        (ja.area, ja.intersects(jb), ja.iou(jb), vars(ja.union(jb)), vars(ja.intersection(jb)))
    lines = [((0, 0), (5, 5)), ((0, 5), (5, 0)), ((1, 1), (1, 9)), ((3, 3), (7, 7)),
             ((9, 9), (9, 9))]
    for s in lines:
        for t in lines:
            l1, l2, j1, j2 = ip.Line(*s), ip.Line(*t), jip.Line(*s), jip.Line(*t)
            assert l1.intersects(l2) == j1.intersects(j2)
            assert (l1.length, l1.is_horizontal(), l1.distance_to_point(t[0])) == \
                (j1.length, j1.is_horizontal(), j1.distance_to_point(t[0]))


def test_drawing_matches_jax():
    rng = np.random.default_rng(3)
    for trial in range(5):
        pts = rng.integers(-3, 23, (int(rng.integers(3, 9)), 2))
        a, b = np.zeros((20, 20), np.uint8), np.zeros((20, 20), np.uint8)
        ip.draw_polygon(a, pts, 7)
        jip.draw_polygon(b, pts, 7)
        ip.fill_polygon(a, pts, 3)
        jip.fill_polygon(b, pts, 3)
        r = ip.Rect(*map(int, rng.integers(-2, 22, 4)))
        ip.draw_rect(a, r, 9)
        jip.draw_rect(b, jip.Rect(*vars(r).values()), 9)
        ip.fill_rect(a, ip.Rect(2, 3, 6, 8), 5)
        jip.fill_rect(b, jip.Rect(2, 3, 6, 8), 5)
        ip.draw_line(a, tuple(pts[0]), tuple(pts[-1]), 11)
        jip.draw_line(b, tuple(pts[0]), tuple(pts[-1]), 11)
        np.testing.assert_array_equal(a, b)
    chw_a, chw_b = np.zeros((3, 8, 8), np.float32), np.zeros((3, 8, 8), np.float32)
    ip.draw_line(chw_a, (0, 0), (7, 5), 0.5)
    jip.draw_line(chw_b, (0, 0), (7, 5), 0.5)
    np.testing.assert_array_equal(chw_a, chw_b)


def test_normalize_image_on_the_tensors_device():
    img = np.random.default_rng(4).random((3, 6, 5)).astype(np.float32)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    want = jip.normalize_image(img, mean, std)
    for x in (torch.from_numpy(img), img):
        got = ip.normalize_image(x, mean, std, device="cpu")
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_imageio_matches_jax(tmp_path):
    hwc = (np.random.default_rng(5).random((8, 6, 3)) * 255).astype(np.uint8)
    chw = imageio.image_to_tensor(hwc, device="cpu")
    assert isinstance(chw, torch.Tensor) and chw.dtype == torch.float32
    np.testing.assert_array_equal(chw.numpy(), jio.image_to_tensor(hwc))
    np.testing.assert_array_equal(imageio.image_to_tensor(hwc[:, :, 0], device="cpu").numpy(),
                                  jio.image_to_tensor(hwc[:, :, 0]))
    np.testing.assert_array_equal(imageio.tensor_to_image(chw), jio.tensor_to_image(chw.numpy()))
    np.testing.assert_array_equal(imageio.tensor_to_image(chw), hwc)
    path = str(tmp_path / "img.png")
    imageio.write_image(path, chw)
    np.testing.assert_array_equal(imageio.read_image(path, device="cpu").numpy(),
                                  jio.read_image(path))
