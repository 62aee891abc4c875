"""The port's Evaluator modes and context-parallel engines vs the JAX
package's, on the CPU.

Both packages get the tiny config, the same Flax weights (bridged into the
port), the same frames and the same scribbles (the port's robot, run once
on the first engine's masks, so that every engine sees the same calls).

- The port's one round (monolithic) against JAX's segmented round (its
  default `round_segments` 5), in both matching-memory modes and with
  both backends; the port's Evaluator refuses any `round_segments` but 1.
- Context-parallel eval (stacked memory) and the context-parallel stream,
  on a 2 x 4 mesh of CPU members: masks equal to the port's
  single-device engine, probabilities to 1e-5.
- Against the JAX engines (their cp modes on JAX's 2 x 4 CPU mesh): f32
  masks equal except at pixels where JAX's top-2 probabilities lie within
  1e-5 (argmax ties; the packages differ in f32 summation order, as in
  tests/test_torch_evaluator.py), probabilities to 1e-4 (as in
  tests/test_torch_streaming.py); int8 labels agree on >= 0.999 of the
  pixels and probabilities to 1e-4 on average (as in
  tests/test_torch_evaluator.py's int8 session: a query channel on a
  quantization edge can land one step apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.engine.evaluator import Evaluator as JaxEvaluator
from cvpr2020_manet_tpu.engine.streaming import StreamingIVOS as JaxStreaming
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu.models.layers import resize_bilinear as jax_resize
from cvpr2020_manet_tpu.parallel.mesh import create_mesh as jax_mesh
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.engine.streaming import StreamingIVOS
from cvpr2020_manet_tpu_torch.interactive.robot import (
    InteractiveScribblesRobot)
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
from cvpr2020_manet_tpu_torch.weights import load_flax_params

TIE = 1e-5
JAX_BACKEND = {"auto": "jnp", "int8": "pallas_int8_interpret"}
MIN_AGREE_INT8 = 0.999
MEAN_DPROB_INT8 = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh():
    return create_mesh(data=2, context=4, devices=[torch.device("cpu")] * 8)


def _configs(**eval_kw):
    return tuple(dataclasses.replace(c, eval=dataclasses.replace(
        c.eval, **eval_kw)) for c in (jax_tiny(), tiny_test_config()))


def _models(jcfg, tcfg, backend):
    """A JAX model with its variables and the port's model on the same
    weights."""
    jmodel = JaxMANet(jcfg.model, matching_backend=JAX_BACKEND[backend])
    h, w = (n + (-n) % jcfg.eval.pad_to for n in jcfg.eval.image_size)
    o = jcfg.model.max_objects + 1
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
        jnp.zeros((1, h // 4, w // 4, o)), jnp.zeros((1, h // 4, w // 4, o)))
    tmodel = load_flax_params(
        MANet(tcfg.model, device="cpu", matching_backend=backend),
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    return jmodel, variables, tmodel


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dataset(cfg):
    return SyntheticDataset(image_size=cfg.eval.image_size,
                            num_frames=cfg.eval.max_frames, num_sequences=1,
                            num_objects=2, scribble_sets=1)


def _rounds(ev, ds, scribbles, n_rounds=3):
    """Rounds of one sequence. `scribbles`: a list to replay, or an empty
    list that the robot fills from this run's masks. -> (masks, probs per
    round, final state)."""
    seq = ds.sequences()[0]
    gt = ds.gt_masks(seq)
    n_obj = ds.num_objects(seq)
    st = ev.start_sequence(ds.images(seq), n_obj)
    robot = InteractiveScribblesRobot()
    masks, probs = np.zeros_like(gt), []
    per_round = []
    for r in range(n_rounds):
        if len(scribbles) == r:
            scribbles.append(robot.interact(seq, masks, gt, n_obj).to_json())
        masks = ev.run_round(st, scribbles[r], gt.shape[1:], n_obj)
        per_round.append(masks.copy())
        probs.append(_np(st.prev_masks)[:st.num_frames])
    return per_round, probs, st


def _assert_same_engine(a, b):
    """Two port engines that must agree: masks equal, state to 1e-5."""
    for r, (ma, mb) in enumerate(zip(a[0], b[0])):
        np.testing.assert_array_equal(ma, mb, err_msg=f"round {r}")
    for pa, pb in zip(a[1], b[1]):
        np.testing.assert_allclose(pa, pb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(a[2].gmap_mem), _np(b[2].gmap_mem),
                               rtol=1e-5, atol=1e-6)


def _assert_matches_jax(port, jax_run, backend, hw_pad):
    """The port's rounds against JAX's (tolerances in the docstring)."""
    h, w = port[0][0].shape[1:]
    for r, (tm, jm, tp, jp) in enumerate(zip(port[0], jax_run[0], port[1],
                                             jax_run[1])):
        if backend == "int8":
            assert (tm == jm).mean() >= MIN_AGREE_INT8, f"round {r}"
            assert np.abs(tp - jp).mean() <= MEAN_DPROB_INT8, f"round {r}"
            continue
        up = np.sort(np.asarray(jax_resize(jnp.asarray(jp), hw_pad)), axis=-1)
        tie = (up[..., -1] - up[..., -2] <= TIE)[:, :h, :w]
        assert not ((tm != jm) & ~tie).any(), f"round {r}"
        np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-4,
                                   err_msg=f"round {r}")
    assert (port[0][-1] > 0).mean() > 0.05           # not all background


def _hw_pad(cfg):
    return tuple(n + (-n) % cfg.eval.pad_to for n in cfg.eval.image_size)


@pytest.mark.parametrize("memory_mode,backend", [
    ("min_fused", "auto"), ("stacked", "auto"),
    ("min_fused", "int8"), ("stacked", "int8")])
def test_segmented_round_matches_monolithic_and_jax(memory_mode, backend):
    """Three rounds (stacked: live pages 1, 2, 4) of JAX's segmented round
    (`round_segments` 5, its default) against the port's monolithic
    round, the only one it runs."""
    jcfg, tcfg = _configs(matching_memory=memory_mode)
    assert (jcfg.eval.round_segments, tcfg.eval.round_segments) == (5, 1)
    jmodel, variables, tmodel = _models(jcfg, tcfg, backend)
    ds = _dataset(tcfg)
    scribbles = []
    port = _rounds(Evaluator(tcfg, tmodel, device="cpu"), ds, scribbles)
    if memory_mode == "stacked":
        # three rounds of annotated pixels in their slots, none after
        live = (_np(port[2].mem_onehot).reshape(
            tcfg.eval.max_interactions, -1).sum(1) > 0)
        assert live.tolist() == [True] * 3 + [False] * (len(live) - 3)
    jrun = _rounds(JaxEvaluator(jcfg, jmodel, variables), ds, scribbles)
    _assert_matches_jax(port, jrun, backend, _hw_pad(tcfg))


@pytest.mark.parametrize("segments", [0, 2, 5])
def test_evaluator_refuses_segmented_rounds(segments):
    """The port runs the monolithic round only: any other `round_segments`
    is refused when the Evaluator is built."""
    _, tcfg = _configs(round_segments=segments)
    with pytest.raises(ValueError, match="round_segments"):
        Evaluator(tcfg, MANet(tcfg.model, device="cpu"), device="cpu")


@pytest.mark.parametrize("option", ["gmap_refresh", "ablate_memory"])
def test_memory_options_match_jax(option):
    """gmap_refresh=0.5 (stored minima relax toward 1.0 each round) and
    ablate_memory (no min-fusion, no MA gate) against JAX's, over three
    rounds; a relaxed memory sits closer to 1.0 than the default one."""
    kw = {"gmap_refresh": 0.5} if option == "gmap_refresh" else {}
    jcfg, tcfg = _configs(round_segments=1, **kw)
    jmodel, variables, tmodel = _models(jcfg, tcfg, "auto")
    ds = _dataset(tcfg)
    ev_kw = {"ablate_memory": True} if option == "ablate_memory" else {}
    scribbles = []
    port = _rounds(Evaluator(tcfg, tmodel, device="cpu", **ev_kw), ds,
                   scribbles)
    jrun = _rounds(JaxEvaluator(jcfg, jmodel, variables, **ev_kw), ds,
                   scribbles)
    _assert_matches_jax(port, jrun, "auto", _hw_pad(tcfg))
    np.testing.assert_allclose(_np(port[2].gmap_mem), _np(jrun[2].gmap_mem),
                               rtol=1e-4, atol=1e-4)
    _, plain_cfg = _configs(round_segments=1)
    plain = _rounds(Evaluator(plain_cfg, tmodel, device="cpu"), ds,
                    scribbles)
    assert _np(port[2].gmap_mem).mean() > _np(plain[2].gmap_mem).mean()


def _count_cp_calls(monkeypatch, module):
    """Count `module`'s context-parallel matching calls."""
    calls = []
    real = module.cp_match_flat

    def spy(*args):
        calls.append(args[3].shape)
        return real(*args)
    monkeypatch.setattr(module, "cp_match_flat", spy)
    return calls


def test_cp_eval_round_matches_single_device_and_jax(monkeypatch):
    """Context-sharded stacked-memory eval (JAX:
    tests/test_parallel.py::test_cp_eval_round_matches_single_device): the
    port's Evaluator with a 2 x 4 CPU mesh gives the single-device masks
    across rounds, and JAX's cp Evaluator's; it matches through the mesh
    once a round."""
    from cvpr2020_manet_tpu_torch.engine import evaluator
    jcfg, tcfg = _configs(matching_memory="stacked", round_segments=1)
    jmodel, variables, tmodel = _models(jcfg, tcfg, "auto")
    ds = _dataset(tcfg)
    scribbles = []
    single = _rounds(Evaluator(tcfg, tmodel, device="cpu"), ds, scribbles)
    calls = _count_cp_calls(monkeypatch, evaluator)
    cp = _rounds(Evaluator(tcfg, tmodel, device="cpu", cp_mesh=_cpu_mesh()),
                 ds, scribbles)
    assert calls == [{"data": 2, "context": 4}] * 3
    _assert_same_engine(single, cp)
    jrun = _rounds(JaxEvaluator(jcfg, jmodel, variables,
                                cp_mesh=jax_mesh(data=2, context=4)),
                   ds, scribbles)
    _assert_matches_jax(cp, jrun, "auto", _hw_pad(tcfg))


def test_cp_stream_matches_single_device_and_jax(monkeypatch):
    """The stream with its live pages sharded over a 2 x 4 CPU mesh (JAX:
    tests/test_streaming.py's cp check): observe, then three corrections
    (live pages 1, 2, 4) with observes between; masks equal to the
    single-device stream's and to JAX's cp stream's."""
    jcfg, tcfg = _configs()
    jmodel, variables, tmodel = _models(jcfg, tcfg, "auto")
    ds = SyntheticDataset(image_size=tcfg.eval.image_size, num_frames=5,
                          num_sequences=1, num_objects=2)
    seq = ds.sequences()[0]
    u8 = (np.clip(ds.images(seq), 0, 1) * 255).astype(np.uint8)
    gt = ds.gt_masks(seq)
    streams = {"single": StreamingIVOS(tcfg, tmodel, device="cpu"),
               "cp": StreamingIVOS(tcfg, tmodel, device="cpu",
                                   cp_mesh=_cpu_mesh()),
               "jax": JaxStreaming(jcfg, jmodel, variables,
                                   cp_mesh=jax_mesh(data=2, context=4))}
    for s in streams.values():
        s.reset(num_objects=2)
    robot = InteractiveScribblesRobot()
    from cvpr2020_manet_tpu_torch.engine import streaming
    calls = _count_cp_calls(monkeypatch, streaming)

    def call(name, arg):
        out = {k: s.observe(arg) if name == "observe" else s.correct(arg)
               for k, s in streams.items()}
        probs = {k: _np(s.state["cur_probs"]) for k, s in streams.items()}
        np.testing.assert_array_equal(out["cp"], out["single"], err_msg=name)
        np.testing.assert_allclose(probs["cp"], probs["single"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(out["cp"], out["jax"], err_msg=name)
        np.testing.assert_allclose(probs["cp"], probs["jax"], rtol=1e-4,
                                   atol=1e-4)
        return out["cp"]

    m = call("observe", u8[0])
    pages = []
    for f in range(1, 4):
        call("correct", robot.scribble_frame(m, gt[f - 1], 2, f - 1, 5,
                                             seq).to_json())
        pages.append(streams["cp"].live_pages())
        m = call("observe", u8[f])
    assert pages == [1, 2, 4]
    assert calls == [{"data": 2, "context": 4}] * 4     # one per observe
    assert (m > 0).mean() > 0.05
