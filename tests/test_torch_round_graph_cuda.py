"""The round's sweep on CUDA graphs against an eager loop, on the card.

On a CUDA device `Evaluator._sweep_impl` replays one captured step per
step shape (`engine/round_graph.py`). Here every graphed round is held
bit for bit against the same round whose sweep is a loop this test
writes from `MANet.propagate` with the arguments the eager sweep gives
it, from the same features and scribbles: the probabilities and global
minima handed on, the label maps, and the kernel launches that
`build.LAUNCHES` counts. A model with local matching at half resolution,
so that kernel 2 runs inside the graph, and kernel 7 too in bf16. Cases:
object buckets 4 and 9; the annotated frame first, in the middle and
last; bf16 and f32; a frame bucket with padding frames; stacked memory
and the ablated memories; a feature map whose local matching takes the
general resize; two sequences with different features through one
evaluator, which share its graph and must each get their own answer; and
a sequence on a card that is not the current one (with two cards). A
CUDA graph exists only on the card, so these tests skip without a GPU. On
a machine with one (and no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_round_graph_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.engine.round_graph import SweepSteps
from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.models import MANet

pytestmark = pytest.mark.cuda

SIZE = (64, 96)         # features 16 x 24, local matching at 8 x 12
ROUNDS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs are the card's")


def _cfg(size=SIZE, pad_to=16, dtype="bfloat16", **eval_kw):
    cfg = tiny_test_config()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, dtype=dtype,
                                  local_downsample=2, max_objects=8),
        eval=dataclasses.replace(cfg.eval, image_size=size, pad_to=pad_to,
                                 max_frames=8, frame_buckets=(4, 8),
                                 max_interactions=ROUNDS, **eval_kw))


class EagerSteps(SweepSteps):
    """The sweep as the eager loop runs it: `propagate` and the softmax a
    step, the carry reset where the sweep starts and turns."""

    def run(self, feat, emb, gmap, gm_pre, head, frame, prev_frame,
            fwd_len):
        probs_seq, g_seq = [], []
        carry = head["int_probs"]
        for j in range(len(frame)):
            f = int(frame[j])
            if j == fwd_len:
                carry = head["int_probs"]
            logits, g_new = self.model.propagate(
                feat[f], emb[f], head["ref_emb"], head["ref_onehot"], None,
                gmap[f], emb[int(prev_frame[j])], carry, head["int_mem"],
                head["obj_valid"], gmap_override=gm_pre[j],
                head_pre=head["head_fp"][f][None] + head["head_mp"])
            carry = torch.softmax(logits, dim=-1)
            probs_seq.append(carry)
            g_seq.append(g_new)
        return torch.stack(probs_seq), torch.stack(g_seq)


def _pair(cfg, seed=0, device="cuda", **kw):
    """(graphed evaluator, eager evaluator) over one model."""
    model = MANet(cfg.model, device=device, seed=seed)
    graphed = Evaluator(cfg, model, device=device, **kw)
    eager = Evaluator(cfg, model, device=device, **kw)
    eager._steps = EagerSteps(model)
    return graphed, eager


def _frames(cfg, n, seed):
    g = np.random.default_rng(seed)
    return g.integers(0, 256, (n, *cfg.eval.image_size, 3), dtype=np.uint8)


def _raster(cfg, n_obj, seed):
    """A padded scribble raster: a block per object and one of
    background, the rest unscribbled."""
    h, w = ((x + (-x) % cfg.eval.pad_to) for x in cfg.eval.image_size)
    r = np.full((h, w), -1, np.int8)
    g = np.random.default_rng(seed)
    for o in range(n_obj + 1):
        y, x = g.integers(0, h - 8), g.integers(0, w - 8)
        r[y:y + 8, x:x + 8] = o
    return r


def _round(ev, st, raster, annot, n_obj, hw):
    """-> (labels, the launches the round counted)."""
    build.reset_launches()
    masks = ev.collect_round(ev.dispatch_round(st, raster, annot, n_obj), hw)
    torch.cuda.synchronize()
    return masks, dict(build.LAUNCHES)


def _check_rounds(cfg, graphed, eager, frames, n_obj, annots, seed=0):
    """Both evaluators through the same rounds from the same features;
    every round's state, labels and launches equal. -> the graphed
    evaluator's state."""
    hw = frames.shape[1:3]
    st_g = graphed.start_sequence(frames, n_obj)
    st_e = eager._init_state(st_g.feat, st_g.emb, st_g.num_frames, n_obj)
    for r, annot in enumerate(annots):
        raster = _raster(cfg, n_obj, seed * 100 + r)
        got, got_launches = _round(graphed, st_g, raster, annot, n_obj, hw)
        want, want_launches = _round(eager, st_e, raster, annot, n_obj, hw)
        assert torch.equal(st_g.prev_masks, st_e.prev_masks), r
        assert torch.equal(st_g.gmap_mem, st_e.gmap_mem), r
        assert torch.equal(st_g.int_mem, st_e.int_mem), r
        np.testing.assert_array_equal(got, want)
        assert got_launches == want_launches, r
        assert got_launches["local_matching"] == st_g.feat.shape[0] - 1
    return st_g


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_obj,bucket", [(2, 4), (5, 9)])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_graphed_round_equals_the_eager_loop(cuda, n_obj, bucket, where,
                                             dtype):
    cfg = _cfg(dtype=dtype)
    graphed, eager = _pair(cfg)
    n = 8
    annot = {"first": 0, "middle": n // 2, "last": n - 1}[where]
    st = _check_rounds(cfg, graphed, eager, _frames(cfg, n, 1), n_obj,
                       [annot, (annot + 3) % n, annot])
    assert st.prev_masks.shape[-1] == bucket
    key, = graphed._steps.graphs
    assert key == (*st.prev_masks.shape[1:], DTYPES[dtype], st.emb.device)


def test_padding_frames_keep_their_state(cuda):
    """6 real frames in the bucket of 8, annotated at the last real one."""
    cfg = _cfg()
    graphed, eager = _pair(cfg)
    st = _check_rounds(cfg, graphed, eager, _frames(cfg, 6, 2), 2,
                       [5, 0, 3])
    assert st.feat.shape[0] == 8


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["stacked", "ablate_memory"])
def test_memory_modes(cuda, mode, dtype):
    cfg = (_cfg(dtype=dtype, matching_memory="stacked") if mode == "stacked"
           else _cfg(dtype=dtype, gmap_refresh=0.5))
    kw = {"ablate_memory": True} if mode == "ablate_memory" else {}
    graphed, eager = _pair(cfg, **kw)
    _check_rounds(cfg, graphed, eager, _frames(cfg, 8, 3), 5, [2, 6, 0])


def test_general_resize_inside_the_graph(cuda):
    """Features of 9 x 13: local matching's halving and its way back take
    the general resize, whose constants are made before the capture."""
    cfg = _cfg(size=(36, 52), pad_to=4)
    graphed, eager = _pair(cfg)
    st = _check_rounds(cfg, graphed, eager, _frames(cfg, 4, 4), 2,
                       [1, 3, 0])
    assert st.feat.shape[1:3] == (9, 13)


def test_sequences_share_a_graph_and_keep_their_answers(cuda):
    """Two sequences of the same shape through one evaluator, their rounds
    interleaved: one graph, and each round equal to its own eager round
    (a slot left aliased to the first sequence would show)."""
    cfg = _cfg()
    graphed, eager = _pair(cfg)
    hw = SIZE
    states = []
    for k in range(2):
        frames = _frames(cfg, 8, 10 + k)
        st_g = graphed.start_sequence(frames, 2)
        st_e = eager._init_state(st_g.feat, st_g.emb, st_g.num_frames, 2)
        states.append((st_g, st_e))
    assert not torch.equal(states[0][0].emb, states[1][0].emb)
    outs = []
    for r in range(ROUNDS):
        for k, (st_g, st_e) in enumerate(states):
            raster = _raster(cfg, 2, 10 * k + r)
            got, _ = _round(graphed, st_g, raster, (3 * k + r) % 8, 2, hw)
            want, _ = _round(eager, st_e, raster, (3 * k + r) % 8, 2, hw)
            assert torch.equal(st_g.prev_masks, st_e.prev_masks), (k, r)
            assert torch.equal(st_g.gmap_mem, st_e.gmap_mem), (k, r)
            np.testing.assert_array_equal(got, want)
            outs.append(got)
    assert len(graphed._steps.graphs) == 1
    assert any(not np.array_equal(a, b) for a, b in zip(outs[::2],
                                                        outs[1::2]))


def test_replays_count_what_their_capture_counted(cuda):
    """A step's launches, counted at the capture, are added at each replay
    and the warm-up's and the capture's are not: the round that captures
    and the next, which only replays, count what the eager loop's round
    counts, and the capture counted one step's."""
    cfg = _cfg()
    graphed, eager = _pair(cfg)
    frames = _frames(cfg, 8, 5)
    counts = []
    for ev in (graphed, graphed, eager):
        st = ev.start_sequence(frames, 2)
        counts.append(_round(ev, st, _raster(cfg, 2, 0), 3, 2, SIZE)[1])
    assert counts[0] == counts[1] == counts[2]
    graph, = graphed._steps.graphs.values()
    assert graph.counted["local_matching"] == 1
    assert graph.counted["group_norm"] > 0
    assert counts[0]["group_norm"] >= 7 * graph.counted["group_norm"]


def test_graphed_round_on_a_device_that_is_not_current(cuda):
    """A sequence on the second card while the first is current: its step
    is captured and replayed there (a capture on the first card's stream
    would record nothing and every replay leave the carry stale), and each
    round equals the eager loop's there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    torch.cuda.set_device(0)
    cfg = _cfg()
    graphed, eager = _pair(cfg, device="cuda:1")
    st = _check_rounds(cfg, graphed, eager, _frames(cfg, 8, 6), 2,
                       [0, 4, 7])
    assert torch.cuda.current_device() == 0
    key, = graphed._steps.graphs
    assert key[-1] == st.emb.device == torch.device("cuda", 1)
    (_, stream), = graphed._steps.capture.values()
    assert stream.device == torch.device("cuda", 1)
