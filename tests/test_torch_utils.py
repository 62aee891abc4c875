"""The port's small utilities against the JAX package's, on the CPU:
`utils/meters.py`, `utils/profiling.py`'s Chrome trace and
`utils/visualize.py` (with the RGB PNG writer of `utils/colormap.py`).
Counterparts of `tests/test_utils.py` and `tests/test_visualize.py`; the
spans of `profiling.annotate` are `tests/test_torch_spans.py`'s."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from cvpr2020_manet_tpu.utils import meters as jax_meters
from cvpr2020_manet_tpu.utils import visualize as jax_visualize
from cvpr2020_manet_tpu_torch.interactive.scribbles import Scribbles
from cvpr2020_manet_tpu_torch.utils import colormap, profiling, visualize
from cvpr2020_manet_tpu_torch.utils.meters import AverageMeter


@pytest.mark.parametrize("seed", [0, 1])
def test_average_meter_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = AverageMeter(), jax_meters.AverageMeter()
    assert ours.avg == theirs.avg == 0.0
    for _ in range(20):
        v, n = float(rng.normal()), int(rng.integers(1, 5))
        ours.update(v, n)
        theirs.update(v, n)
        assert (ours.avg, ours.count, ours.sum) == \
            (theirs.avg, theirs.count, theirs.sum)
    ours.reset()
    assert (ours.sum, ours.count, ours.avg) == (0.0, 0, 0.0)


def test_trace_writes_chrome_trace_on_cpu(tmp_path):
    """`trace` on CPU tensors writes a Chrome trace that holds the
    `annotate` span and the operators run inside it."""
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("manet_span"):
            (x @ x).sum()
    path = tmp_path / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "manet_span" in names
    assert any(n and "mm" in n for n in names)


@pytest.mark.parametrize("alpha", [0.5, 0.3, 1.0])
def test_overlay_masks_bit_equal_to_jax(alpha):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    labels = rng.integers(0, 5, (24, 40)).astype(np.int32)
    got = visualize.overlay_masks(img, labels, alpha=alpha)
    want = jax_visualize.overlay_masks(img, labels, alpha=alpha)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="shape mismatch"):
        visualize.overlay_masks(img, labels[:-1])


def _payload(rng, frames=3):
    lines = []
    for _ in range(frames):
        frame = []
        for _ in range(int(rng.integers(0, 4))):
            n = int(rng.integers(1, 6))
            frame.append({"path": rng.random((n, 2)).round(4).tolist(),
                          "object_id": int(rng.integers(0, 4))})
        lines.append(frame)
    return {"sequence": "s", "scribbles": lines}


@pytest.mark.parametrize("radius", [0, 1, 2])
@pytest.mark.parametrize("seed", [5, 6])
def test_draw_scribbles_bit_equal_to_jax(seed, radius):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (30, 50, 3), dtype=np.uint8)
    payload = _payload(rng)
    for frame in range(3):
        want = jax_visualize.draw_scribbles(img, payload, frame, radius)
        for scr in (payload, Scribbles.from_json(payload)):
            got = visualize.draw_scribbles(img, scr, frame, radius)
            np.testing.assert_array_equal(got, want)


def test_save_image_decodes_with_pil(tmp_path):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (17, 29, 3), dtype=np.uint8)
    path = tmp_path / "frame.png"
    visualize.save_image(str(path), img)
    with Image.open(path) as decoded:
        assert decoded.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(decoded), img)
    with pytest.raises(ValueError, match="H, W, 3"):
        colormap.save_rgb_png(str(path), img[..., 0])
