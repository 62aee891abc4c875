"""The PyTorch port's StreamingIVOS vs the JAX one, on the CPU.

Both engines get the same Flax weights (bridged into the port), the same
frames and the same scribbles, and run the same calls: observe before any
memory, a correction, observes with the three ingest formats (uint8 RGB,
planar YUV 4:2:0, host-normalized floats), a second and a third correction
(live pages 1 -> 2 -> 4) and more observes, one of them pipelined.

f32 (JAX's plain oracle against the port's plain kernel versions): the
two differ in f32 summation order only, so probabilities agree to 1e-4
and masks are equal.

int8 (JAX's interpret-mode int8 kernel against the port's plain int8
version): the quantizers are bit-equal, but their inputs, the embeddings,
differ by ~1e-6 between the packages, so a channel that lies on a rounding
edge can land one step (s_q = max|q| / 127 of that row) apart. The
difference stays local to such pixels: label agreement >= 0.999 per mask
and a mean probability difference <= 1e-4 per frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.engine.streaming import StreamingIVOS as JaxStreaming
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine.streaming import StreamingIVOS
from cvpr2020_manet_tpu_torch.interactive.robot import (
    InteractiveScribblesRobot)
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.utils.ingest import rgb_to_yuv420_host
from cvpr2020_manet_tpu_torch.weights import load_flax_params

BACKENDS = {"f32": ("jnp", "auto"), "int8": ("pallas_int8_interpret", "int8")}
MIN_AGREE_INT8 = 0.999
MEAN_DPROB_INT8 = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(mode):
    jcfg, tcfg = jax_tiny(), tiny_test_config()
    jbackend, tbackend = BACKENDS[mode]
    jmodel = JaxMANet(jcfg.model, matching_backend=jbackend)
    h, w = jcfg.eval.image_size
    o = jcfg.model.max_objects + 1
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
        jnp.zeros((1, h // 4, w // 4, o)), jnp.zeros((1, h // 4, w // 4, o)))
    tmodel = load_flax_params(
        MANet(tcfg.model, device="cpu", matching_backend=tbackend),
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    return (JaxStreaming(jcfg, jmodel, variables),
            StreamingIVOS(tcfg, tmodel, device="cpu"), tcfg)


def _sequence(cfg, num_objects=2, num_frames=6):
    h, w = cfg.eval.image_size
    ds = SyntheticDataset(image_size=(h, w), num_frames=num_frames,
                          num_sequences=1, num_objects=num_objects)
    seq = ds.sequences()[0]
    images, gt = ds.images(seq), ds.gt_masks(seq)
    return seq, images, (np.clip(images, 0, 1) * 255).astype(np.uint8), gt


def _compare(mode, jm, tm, jp, tp, what):
    assert tm.shape == jm.shape and tm.dtype == np.int32, what
    if mode == "f32":
        np.testing.assert_array_equal(tm, jm, err_msg=what)
        np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        assert (tm == jm).mean() >= MIN_AGREE_INT8, what
        assert np.abs(tp - jp).mean() <= MEAN_DPROB_INT8, what


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_stream_matches_jax(mode):
    js, ts, cfg = _models(mode)
    seq, images, u8, gt = _sequence(cfg)
    robot = InteractiveScribblesRobot()
    t = len(images)

    def both(call, arg):
        out = [getattr(s, call)(arg) for s in (js, ts)]
        if call == "observe_async":
            out = [f.result() for f in out]
        jp = np.asarray(js.state["cur_probs"])
        tp = ts.state["cur_probs"].numpy()
        _compare(mode, np.asarray(out[0]), out[1], jp, tp, f"{call} {arg_name}")
        assert js.live_pages() == ts.live_pages()
        return out[1]

    for s in (js, ts):
        s.reset(num_objects=2)
    assert ts.live_pages() == 1
    arg_name = "frame 0, no memory"
    m0 = both("observe", u8[0])
    assert (m0 == 0).all()
    arg_name = "correction 1"
    scr = robot.scribble_frame(m0, gt[0], 2, 0, t, seq).to_json()
    both("correct", scr)
    assert ts.live_pages() == 1
    arg_name = "frame 1, uint8"
    both("observe", u8[1])
    arg_name = "frame 2, yuv420"
    both("observe", rgb_to_yuv420_host(u8[2]))
    arg_name = "frame 3, float"
    m3 = both("observe", images[3])
    arg_name = "correction 2"
    scr = robot.scribble_frame(m3, gt[3], 2, 3, t, seq).to_json()
    both("correct", scr)
    assert ts.live_pages() == 2
    arg_name = "frame 4, pipelined"
    m4 = both("observe_async", u8[4])
    arg_name = "correction 3"
    both("correct", robot.scribble_frame(m4, gt[4], 2, 4, t, seq).to_json())
    assert ts.live_pages() == 4
    arg_name = "frame 5"
    both("observe", u8[5])
    assert ts.state["rounds"] == 3


def test_observe_async_reset_and_bits():
    """observe_async gives observe's masks; reset() to another object
    count changes the bit depth, and a frame still in flight is decoded at
    the depth it was packed with."""
    _, ts, cfg = _models("f32")
    _, ts2, _ = _models("f32")
    seq, images, u8, gt = _sequence(cfg)
    robot = InteractiveScribblesRobot()
    scr = robot.scribble_frame(np.zeros_like(gt[0]), gt[0], 2, 0, len(u8),
                               seq).to_json()
    sync, pipelined = [], []
    for s, out, call in ((ts, sync, "observe"), (ts2, pipelined, "async")):
        s.reset(num_objects=2)
        s.observe(u8[0])
        s.correct(scr)
        for f in range(1, 4):
            out.append(s.observe(u8[f]) if call == "observe"
                       else s.observe_async(u8[f]))
    for m, fut in zip(sync, pipelined):
        np.testing.assert_array_equal(m, fut.result())

    ts.reset(num_objects=1)
    assert ts._bits == 1 and ts.live_pages() == 1
    ref = ts.observe(u8[0])
    ts.reset(num_objects=1)
    fut = ts.observe_async(u8[0])              # packed at 1 bit per pixel
    ts.reset(num_objects=2)                    # the stream moves to 2 bits
    assert ts._bits == 2
    np.testing.assert_array_equal(fut.result(), ref)
    m = ts.observe(u8[0])
    assert m.shape == gt.shape[1:] and (m == 0).all()
    m = ts.correct(scr)
    assert m.shape == gt.shape[1:] and m.max() <= 2
    with pytest.raises(ValueError):
        ts.reset(num_objects=cfg.model.max_objects + 1)
