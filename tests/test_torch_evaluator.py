"""A whole interactive session through the PyTorch port vs the JAX
Evaluator, on the CPU.

Both packages get the same synthetic sequence, the same Flax weights
(bridged into the port) and a counter clock, and run the monolithic round
(round_segments=1). Per-round label maps must be equal except at pixels
where the JAX top-2 probabilities lie within 1e-5 (argmax ties; the two
differ only in f32 summation order), and the J and F report rows and the
AUC must be equal.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.data import SyntheticDataset as JaxSynthetic
from cvpr2020_manet_tpu.engine.evaluator import Evaluator as JaxEvaluator
from cvpr2020_manet_tpu.interactive.session import (
    InteractiveSession as JaxSession)
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu.models.layers import resize_bilinear as jax_resize
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.interactive.session import InteractiveSession
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.weights import load_flax_params

TIE = 1e-5


def _configs(image_size, local_downsample, mask_stride=1):
    def adjust(cfg):
        return dataclasses.replace(
            cfg,
            model=dataclasses.replace(cfg.model,
                                      local_downsample=local_downsample),
            eval=dataclasses.replace(cfg.eval, image_size=image_size,
                                     round_segments=1,
                                     mask_stride=mask_stride))
    return adjust(jax_tiny()), adjust(tiny_test_config())


def _counter():
    c = itertools.count()
    return lambda: float(next(c))


@pytest.mark.parametrize("backend,image_size,local_downsample", [
    ("jnp", (32, 48), 1),
    ("pallas_interpret", (32, 48), 1),
    ("jnp", (64, 96), 2),
])
def test_session_matches_jax(backend, image_size, local_downsample):
    _session_vs_jax(backend, image_size, local_downsample)


def test_session_mask_stride_matches_jax():
    """A mask stride of 16 at 32x48: the readback resizes the 8x12
    probabilities to 2x3, a /4 off the resize fast paths, which takes the
    general resize (JAX's `jax.image.resize` fallback). Labels equal at
    every pixel, report rows, AUC and J&F@60s equal."""
    _session_vs_jax("jnp", (32, 48), 1, mask_stride=16, ties=False)


def _session_vs_jax(backend, image_size, local_downsample, mask_stride=1,
                    ties=True):
    """Both sessions, compared; `ties` excuses labels at argmax ties."""
    jcfg, tcfg = _configs(image_size, local_downsample, mask_stride)
    kw = dict(image_size=image_size, num_frames=jcfg.eval.max_frames,
              num_sequences=1, num_objects=2, scribble_sets=1)
    jds, tds = JaxSynthetic(**kw), SyntheticDataset(**kw)

    jmodel = JaxMANet(jcfg.model, matching_backend=backend)
    h, w = image_size
    o = jcfg.model.max_objects + 1
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
        jnp.zeros((1, h // 4, w // 4, o)), jnp.zeros((1, h // 4, w // 4, o)))
    tmodel = load_flax_params(MANet(tcfg.model, device="cpu"),
                              jax.tree_util.tree_map(np.asarray,
                                                     variables["params"]))

    jev = JaxEvaluator(jcfg, jmodel, variables)
    jrun_round = jev.run_round
    jprobs = []

    def capture(state, *args):
        masks = jrun_round(state, *args)
        jprobs.append(np.asarray(state.prev_masks)[:state.num_frames])
        return masks

    jev.run_round = capture
    jmasks, tmasks = [], []
    jsess = JaxSession(jds, max_interactions=2, time_fn=_counter())
    tsess = InteractiveSession(tds, max_interactions=2, time_fn=_counter())
    jsum = jev.run_session(jsess, on_masks=lambda *a: jmasks.append(a[-1]))
    tsum = Evaluator(tcfg, tmodel, device="cpu").run_session(
        tsess, on_masks=lambda *a: tmasks.append(a[-1]))

    assert len(jmasks) == len(tmasks) == 2
    pad, ms = jcfg.eval.pad_to, mask_stride
    hw_mask = ((h + (-h) % pad) // ms, (w + (-w) % pad) // ms)
    for r, (jm, tm, p) in enumerate(zip(jmasks, tmasks, jprobs)):
        up = np.sort(np.asarray(jax_resize(jnp.asarray(p), hw_mask)), axis=-1)
        up = np.repeat(np.repeat(up, ms, axis=1), ms, axis=2)
        tie = (up[..., -1] - up[..., -2] <= TIE)[:, :h, :w] & ties
        differ = jm != tm
        assert not (differ & ~tie).any(), (
            f"round {r}: {int((differ & ~tie).sum())} labels differ "
            "outside argmax ties")

    jrows = jsess.get_report().to_dict("records")
    trows = tsess.get_report()
    assert len(jrows) == len(trows) > 0
    for jr, tr in zip(jrows, trows):
        assert {k: jr[k] for k in tr} == tr
    assert tsum["auc"] == jsum["auc"]
    assert tsum["metric_at_threshold"] == jsum["metric_at_threshold"]


class _Uint8Frames:
    """A dataset view that also offers raw uint8 frames, which
    `run_session` prefers (normalized on the device)."""

    def __init__(self, ds):
        self._ds = ds

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def images_uint8(self, seq):
        return (np.clip(self._ds.images(seq), 0, 1) * 255).astype(np.uint8)


def _bridged_pair(jcfg, tcfg, jbackend, tbackend):
    jmodel = JaxMANet(jcfg.model, matching_backend=jbackend)
    h, w = (n + (-n) % jcfg.eval.pad_to for n in jcfg.eval.image_size)
    o = jcfg.model.max_objects + 1
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
        jnp.zeros((1, h // 4, w // 4, o)), jnp.zeros((1, h // 4, w // 4, o)))
    tmodel = load_flax_params(
        MANet(tcfg.model, device="cpu", matching_backend=tbackend),
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    return JaxEvaluator(jcfg, jmodel, variables), \
        Evaluator(tcfg, tmodel, device="cpu")


def test_int8_session_matches_jax():
    """A two-round session in the int8 serving mode, fed uint8 frames, vs
    JAX's Evaluator on its interpret-mode int8 kernel. The quantizers are
    bit-equal, but their inputs (the embeddings) differ by ~1e-6 between
    the packages, so a channel on a rounding edge can land one step apart:
    labels agree on >= 0.999 of the pixels per round, the round's
    probabilities to 1e-4 on average, and AUC and J&F@60s to 1e-3."""
    jcfg, tcfg = _configs((32, 48), 1)
    kw = dict(image_size=(32, 48), num_frames=jcfg.eval.max_frames,
              num_sequences=1, num_objects=2, scribble_sets=1)
    jds, tds = _Uint8Frames(JaxSynthetic(**kw)), _Uint8Frames(
        SyntheticDataset(**kw))
    jev, tev = _bridged_pair(jcfg, tcfg, "pallas_int8_interpret", "int8")
    probs = {"jax": [], "torch": []}
    for name, ev in (("jax", jev), ("torch", tev)):
        run_round = ev.run_round

        def capture(state, *args, run_round=run_round, out=probs[name]):
            masks = run_round(state, *args)
            out.append(np.asarray(state.prev_masks)[:state.num_frames])
            return masks
        ev.run_round = capture
    jmasks, tmasks = [], []
    jsum = jev.run_session(JaxSession(jds, max_interactions=2,
                                      time_fn=_counter()),
                           on_masks=lambda *a: jmasks.append(a[-1]))
    tsum = tev.run_session(InteractiveSession(tds, max_interactions=2,
                                              time_fn=_counter()),
                           on_masks=lambda *a: tmasks.append(a[-1]))
    assert len(jmasks) == len(tmasks) == 2
    for jm, tm, jp, tp in zip(jmasks, tmasks, probs["jax"], probs["torch"]):
        assert (tm == jm).mean() >= 0.999
        assert (tm > 0).mean() > 0.05               # not all background
        assert np.abs(tp - jp).mean() <= 1e-4
    assert abs(tsum["auc"] - jsum["auc"]) <= 1e-3
    assert abs(tsum["metric_at_threshold"]
               - jsum["metric_at_threshold"]) <= 1e-3


def test_start_sequence_uint8_matches_jax():
    """uint8 frames whose size and count both need padding: the port pads
    with the mean byte in space and in frames, as JAX does, and normalizes
    on the device; features and embeddings agree to 1e-4 (f32 model)."""
    jcfg, tcfg = _configs((30, 44), 1)
    jev, tev = _bridged_pair(jcfg, tcfg, "jnp", "auto")
    frames = np.random.default_rng(0).integers(0, 256, (3, 30, 44, 3),
                                               dtype=np.uint8)
    jst = jev.start_sequence(frames, 2)
    tst = tev.start_sequence(frames, 2)
    assert tst.feat.shape[:3] == (4, 8, 12)          # 4-frame bucket, 32x48
    np.testing.assert_allclose(tst.feat.numpy(), np.asarray(jst.feat),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tst.emb.numpy(), np.asarray(jst.emb),
                               rtol=1e-4, atol=1e-4)
