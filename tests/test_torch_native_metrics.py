"""The port's native boundary F-measure (per-row prefix counts of the other
boundary, one span per row offset of the tolerance disk) against the
SciPy oracle of interactive/metrics.py (binary erosion and disk dilation)
and against the JAX package's native kernel (an exact Euclidean distance
transform): the same scores, bit for bit."""

import ctypes

import numpy as np
import pytest
from scipy import ndimage

from cvpr2020_manet_tpu import native as jax_native
from cvpr2020_manet_tpu_torch import native
from cvpr2020_manet_tpu_torch.interactive import metrics as M


@pytest.fixture(scope="module")
def handles():
    port, ref = native.lib(), jax_native.lib()
    assert port is not None and ref is not None, "g++ builds both libraries"
    return port, ref


def _call(handle, pred, gt, radius):
    t, h, w = pred.shape
    out = np.empty(t, np.float64)
    handle.batched_f_measure(
        np.ascontiguousarray(pred, np.uint8).ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(gt, np.uint8).ctypes.data_as(ctypes.c_void_p),
        t, h, w, radius, out.ctypes.data_as(ctypes.c_void_p))
    return out


def _masks(kind, rng, t, h, w):
    if kind == "noise":
        return [rng.random((t, h, w)) < rng.uniform(0.05, 0.95)
                for _ in range(2)]
    if kind == "blobs":
        return [ndimage.uniform_filter(rng.random((t, h, w)), (1, 5, 5))
                > 0.5 for _ in range(2)]
    if kind == "thin":            # one-pixel lines and isolated pixels
        out = []
        for _ in range(2):
            m = rng.random((t, h, w)) < 0.01
            m[:, rng.integers(h)] = True
            m[:, :, rng.integers(w)] = True
            out.append(m)
        return out
    gt = np.zeros((t, h, w), bool)          # "shifted": a moved ellipse
    yy, xx = np.mgrid[:h, :w]
    for f in range(t):
        cy, cx = h / 2 + 3 * f, w / 2 - 2 * f
        gt[f] = (((yy - cy) / (0.3 * h)) ** 2
                 + ((xx - cx) / (0.25 * w)) ** 2 < 1)
    return [np.roll(gt, (4, -6), axis=(1, 2)), gt]


@pytest.mark.parametrize("kind", ["noise", "blobs", "thin", "shifted"])
def test_f_measure_matches_scipy_and_jax(handles, kind):
    port, ref = handles
    rng = np.random.default_rng(["noise", "blobs", "thin",
                                 "shifted"].index(kind))
    for trial in range(12):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        if trial == 0:
            h, w = 120, 214                  # a quarter of 480p
        pred, gt = _masks(kind, rng, 3, h, w)
        radius = int(rng.integers(1, 12))
        # the bound_th that gives `radius` in the oracle's ceil(th * diag)
        th = (radius - 0.5) / np.linalg.norm((h, w))
        assert max(1, int(np.ceil(th * np.linalg.norm((h, w))))) == radius
        want = np.array([M.f_measure(pred[f], gt[f], th) for f in range(3)])
        got = _call(port, pred, gt, radius)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} r={radius}")
        np.testing.assert_array_equal(got, _call(ref, pred, gt, radius))


def test_f_measure_edge_cases_and_nonzero_labels(handles):
    port, ref = handles
    t, h, w = 2, 16, 16
    empty = np.zeros((t, h, w), np.uint8)
    full = np.ones((t, h, w), np.uint8)
    np.testing.assert_array_equal(_call(port, empty, empty, 2), 1.0)
    np.testing.assert_array_equal(_call(port, empty, full, 2), 0.0)
    np.testing.assert_array_equal(_call(port, full, full, 2), 1.0)
    # any nonzero byte is "in", as in the distance-transform kernel
    rng = np.random.default_rng(5)
    pred = (rng.random((t, h, w)) < 0.4).astype(np.uint8)
    gt = (rng.random((t, h, w)) < 0.4).astype(np.uint8)
    np.testing.assert_array_equal(_call(port, pred * 255, gt * 7, 3),
                                  _call(port, pred, gt, 3))
    np.testing.assert_array_equal(_call(port, pred * 255, gt * 7, 3),
                                  _call(ref, pred * 255, gt * 7, 3))
    # the batched per-object mean of the port's metrics module
    labels = rng.integers(0, 3, (t, h, w)).astype(np.int32)
    truth = rng.integers(0, 3, (t, h, w)).astype(np.int32)
    want = np.mean([[M.f_measure(labels[f] == j, truth[f] == j)
                     for j in (1, 2)] for f in range(t)], axis=1)
    np.testing.assert_array_equal(M.batched_f_measure(labels, truth, 2), want)
