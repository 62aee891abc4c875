"""The round's sweep runner (`engine/round_graph.py`) on the CPU.

On the CPU the runner calls each step itself and captures nothing, and
its sweep is the eager loop's bit for bit; the graph key is (h, w, object
bucket, dtype, device); the step spans are no-ops without a profiler. With
torch.cuda's graph calls replaced by fakes that record what they are
given, the graphed path runs here too: its warm-up, capture and replays
run with the sequence's device current and capture on a stream of that
device, and a graphed round counts the launches of the same round run
step by step. The graphed path itself is the card's
(tests/test_torch_round_graph_cuda.py)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine import round_graph
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(cfg, model, dataset, sequence): 3 frames in the bucket of 4, 2
    objects, room for 8."""
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, max_objects=8))
    model = MANet(cfg.model, device="cpu")
    ds = SyntheticDataset(image_size=cfg.eval.image_size, num_frames=3,
                          num_sequences=1, num_objects=2)
    return cfg, model, ds, ds.sequences()[0]


def _session(tiny, ev, rounds=2):
    """A sequence through `rounds` rounds, the same scribbles each."""
    cfg, model, ds, seq = tiny
    images = ds.images(seq)
    st = ev.start_sequence(images, 2)
    scr = ds.initial_scribbles(seq, 0).to_json()
    masks = [ev.run_round(st, scr, images.shape[1:3], 2)
             for _ in range(rounds)]
    return st, masks


class _EagerSteps(round_graph.SweepSteps):
    """The eager loop, written from `propagate` as the sweep called it."""

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


def test_cpu_steps_run_directly_and_capture_nothing(tiny, monkeypatch):
    def forbidden(*_, **__):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", forbidden)
    monkeypatch.setattr(torch.cuda, "graph", forbidden)
    monkeypatch.setattr(round_graph, "StepGraph", forbidden)
    steps = []
    real = round_graph.sweep_step

    def counted(*args, **kw):
        steps.append(args[2].data_ptr())       # emb_f: a view of the frame
        return real(*args, **kw)

    monkeypatch.setattr(round_graph, "sweep_step", counted)
    cfg, model = tiny[:2]
    ev = Evaluator(cfg, model, device="cpu")
    st, _ = _session(tiny, ev)
    t = st.feat.shape[0]
    assert len(steps) == 2 * (t - 1)
    # each step reads its frame of the sequence's own embeddings
    assert set(steps) <= {st.emb[f].data_ptr() for f in range(t)}
    assert ev._steps.graphs == {} and ev._steps.capture == {}


def test_cpu_sweep_equals_the_eager_loop(tiny):
    """Rounds annotated on the first, a middle and the last real frame
    (the sweep turns at each), from the same features."""
    cfg, model, ds, seq = tiny
    ev = Evaluator(cfg, model, device="cpu")
    eager = Evaluator(cfg, model, device="cpu")
    eager._steps = _EagerSteps(model)
    images = ds.images(seq)
    hw = images.shape[1:3]
    st = ev.start_sequence(images, 2)
    st_e = eager._init_state(st.feat, st.emb, st.num_frames, 2)
    raster = np.full(hw, -1, np.int8)
    for o in range(3):
        raster[4 * o:4 * o + 4, 8 * o:8 * o + 8] = o
    for annot in (0, 1, 2, 0):
        got = ev.collect_round(ev.dispatch_round(st, raster, annot, 2), hw)
        want = eager.collect_round(
            eager.dispatch_round(st_e, raster, annot, 2), hw)
        np.testing.assert_array_equal(got, want)
        assert torch.equal(st.prev_masks, st_e.prev_masks)
        assert torch.equal(st.gmap_mem, st_e.gmap_mem)
        assert torch.equal(st.int_mem, st_e.int_mem)


def test_captures_on_cuda_devices_only():
    assert round_graph.captures(torch.device("cuda"))
    assert round_graph.captures(torch.device("cuda", 1))
    assert not round_graph.captures(torch.device("cpu"))
    assert not round_graph.captures(torch.device("meta"))


@pytest.mark.parametrize("h,w", [(8, 12), (9, 13)])
def test_one_graph_key_per_shape_objects_and_dtype(h, w):
    def key(o, dtype=torch.bfloat16, t=8, device="cpu"):
        head = {"int_probs": torch.zeros((h, w, o), device=device)}
        return round_graph.SweepSteps.key(
            head, torch.zeros((t, h, w, 16), dtype=dtype, device=device))
    assert key(4) == (h, w, 4, torch.bfloat16, torch.device("cpu"))
    # the frame bucket does not enter: a graph serves every length
    assert key(4, t=8) == key(4, t=104)
    assert len({key(4), key(9), key(4, torch.float32),
                key(9, torch.float32), key(4, device="meta")}) == 5


class _FakeCuda:
    """torch.cuda's stream and graph calls on the CPU. A fake capture runs
    the step as it is and a fake replay runs nothing; each records the
    device current then (the innermost `torch.cuda.device`)."""

    def __init__(self, monkeypatch):
        self.current = []
        self.streams = []       # the device of each Stream made
        self.warmups = []       # (stream, current device) of each warm-up
        self.captures = []      # (stream, pool, current device)
        self.replays = []       # the current device at each replay
        fake = self

        class Stream:
            def __init__(self, device=None):
                self.device = device
                fake.streams.append(device)

            def wait_stream(self, other):
                pass

        class CUDAGraph:
            def replay(self):
                fake.replays.append(fake.now())

        @contextlib.contextmanager
        def device(d):
            fake.current.append(d)
            try:
                yield
            finally:
                fake.current.pop()

        @contextlib.contextmanager
        def stream(s):
            fake.warmups.append((s, fake.now()))
            yield

        @contextlib.contextmanager
        def graph(g, pool=None, stream=None, capture_error_mode="global"):
            fake.captures.append((stream, pool, fake.now()))
            yield

        for name, value in (
                ("Stream", Stream), ("CUDAGraph", CUDAGraph),
                ("device", device), ("stream", stream), ("graph", graph),
                ("graph_pool_handle", object),
                ("current_stream", lambda d=None: Stream.__new__(Stream))):
            monkeypatch.setattr(torch.cuda, name, value)
        monkeypatch.setattr(round_graph, "captures", lambda d: True)

    def now(self):
        return self.current[-1] if self.current else None


def test_capture_and_replays_on_the_sequences_device(tiny, monkeypatch):
    fake = _FakeCuda(monkeypatch)
    cfg, model = tiny[:2]
    ev = Evaluator(cfg, model, device="cpu")
    st, _ = _session(tiny, ev)
    dev = st.emb.device
    t = st.feat.shape[0]
    # one capture stream, made on the sequence's device, and the warm-up
    # and the capture on it with that device current
    assert fake.streams == [dev]
    (pool, stream), = ev._steps.capture.values()
    assert stream.device == dev
    assert fake.warmups == [(stream, dev)]
    assert fake.captures == [(stream, pool, dev)]
    assert fake.replays == [dev] * (2 * (t - 1))
    key, = ev._steps.graphs
    assert key[-1] == dev


def test_replays_add_what_the_capture_counted(tiny, monkeypatch):
    """Each step counts one launch; a graphed round counts T - 1, as the
    same round run step by step, in the round that captures (its warm-up
    and capture taken back out) and in the next."""
    real = round_graph.sweep_step

    def launching(*args, **kw):
        build.LAUNCHES["local_matching"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(round_graph, "sweep_step", launching)
    cfg, model, ds, seq = tiny
    images = ds.images(seq)
    scr = ds.initial_scribbles(seq, 0).to_json()
    counts = []
    for graphed in (False, True):
        if graphed:
            _FakeCuda(monkeypatch)
        ev = Evaluator(cfg, model, device="cpu")
        st = ev.start_sequence(images, 2)
        for _ in range(2):
            build.reset_launches()
            ev.run_round(st, scr, images.shape[1:3], 2)
            counts.append(dict(build.LAUNCHES))
    t = st.feat.shape[0]
    assert counts[0]["local_matching"] == t - 1
    assert counts == [counts[0]] * 4
    graph, = ev._steps.graphs.values()
    assert graph.counted == {"local_matching": 1}
    build.reset_launches()


def test_step_spans_are_off_without_a_profiler(tiny, monkeypatch):
    def forbidden(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", forbidden)
    cfg, model = tiny[:2]
    _session(tiny, Evaluator(cfg, model, device="cpu"), rounds=1)
