"""The port's phase spans (`utils/profiling.annotate`) on the CPU, at the
tiny configuration.

Under `torch.profiler`, each of `Evaluator.start_sequence`,
`Evaluator.run_round` and `StreamingIVOS.observe` records its outer span
once and its phases in order, nested in it, on the calling thread,
covering at least 95% of it; a round's sweep steps are `manet.round.step`
spans inside its dispatch, one a step, with a `manet.round.replay` span in
each only where a step replays a captured graph (on the card, never on
the CPU); with no profiler running, `annotate` hands back one shared no-op
and builds no `record_function`."""

import dataclasses
import threading
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cvpr2020_manet_tpu_torch import profile_round
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.engine.round_graph import (
    REPLAY_SPAN, STEP_SPAN)
from cvpr2020_manet_tpu_torch.engine.streaming import StreamingIVOS
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.utils import profiling

COVER = 0.95
PHASES = {
    "start_sequence": ("manet.start_sequence",
                       ["manet.start.pad", "manet.start.encode"]),
    "run_round": ("manet.round",
                  ["manet.round.rasterize", "manet.round.dispatch",
                   "manet.round.wait", "manet.round.unpack"]),
    "observe": ("manet.observe",
                ["manet.observe.ingest", "manet.observe.dispatch",
                 "manet.observe.wait"]),
}
# spans nested in a phase, and the phase that holds them
NESTED = {STEP_SPAN: "manet.round.dispatch",
          REPLAY_SPAN: "manet.round.dispatch"}
STEPS = 3           # a round's sweep steps: the frame bucket is 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(cfg, model, dataset, sequence): 3 frames (the bucket is 4, so the
    start pads frames too), 2 objects, uint8 frames."""
    cfg = tiny_test_config()
    model = MANet(cfg.model, device="cpu")
    ds = SyntheticDataset(image_size=cfg.eval.image_size, num_frames=3,
                          num_sequences=1, num_objects=2)
    return cfg, model, ds, ds.sequences()[0]


def _u8(images):
    return (np.clip(images, 0, 1) * 255).astype(np.uint8)


def _call(what, tiny):
    """-> the one call whose spans the test reads, its engine made ready
    (a round after a first one on the same state)."""
    cfg, model, ds, seq = tiny
    frames = _u8(ds.images(seq))
    if what == "observe":
        s = StreamingIVOS(cfg, model, device="cpu")
        s.reset(2)
        s.observe(frames[0])
        s.correct(ds.initial_scribbles(seq, 0).to_json())
        return lambda: s.observe(frames[1])
    ev = Evaluator(cfg, model, device="cpu")
    if what == "start_sequence":
        return lambda: ev.start_sequence(frames, 2)
    st = ev.start_sequence(frames, 2)
    scr = ds.initial_scribbles(seq, 0).to_json()
    ev.run_round(st, scr, frames.shape[1:3], 2)     # first-call costs
    return lambda: ev.run_round(st, scr, frames.shape[1:3], 2)


def _spans(prof):
    """[(name, start_ns, end_ns, thread)] of the `manet.*` spans, by
    start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("manet.")), key=lambda r: r[1])


def _traced(call):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("test.caller"):
            call()
    spans = _spans(prof)
    caller, = [e for e in prof.profiler.kineto_results.events()
               if e.name() == "test.caller"]
    return spans, caller.start_thread_id()


def _cover(spans, outer_name):
    """The share of the outer span that its phases cover."""
    (_, a, b, _), = [s for s in spans if s[0] == outer_name]
    return sum(e - s for n, s, e, _ in spans
               if n != outer_name and n not in NESTED) / (b - a)


def _best_cover(call, outer_name, spans):
    """The phases' cover of the outer span, the best of this trace and two
    more: the gaps between phases are a few statements, but a busy host
    can preempt the thread there; the structure is held on every trace."""
    covers = [_cover(spans, outer_name)]
    for _ in range(2):
        more, _ = _traced(call)
        assert [s[0] for s in more] == [s[0] for s in spans]
        covers.append(_cover(more, outer_name))
    return max(covers)


@pytest.mark.parametrize("what", list(PHASES))
def test_call_emits_its_phases_once_in_order(tiny, what):
    call = _call(what, tiny)
    outer_name, phases = PHASES[what]
    spans, thread = _traced(call)
    outer = [s for s in spans if s[0] == outer_name]
    assert len(outer) == 1, spans
    _, a, b, tid = outer[0]
    assert tid == thread
    inner = [s for s in spans if s[0] != outer_name and s[0] not in NESTED]
    assert [s[0] for s in inner] == phases
    for name, s, e, t in inner:
        assert a <= s <= e <= b, name
        assert t == thread, name
    # the phases follow one another: none overlaps the next
    assert all(x[2] <= y[1] for x, y in zip(inner, inner[1:]))
    nested = [s for s in spans if s[0] in NESTED]
    if what == "run_round":
        # one step span a sweep step, none replayed on the CPU
        assert [s[0] for s in nested] == [STEP_SPAN] * STEPS
    assert not nested or what == "run_round"
    for name, s, e, t in nested:
        (_, pa, pb, _), = [x for x in inner if x[0] == NESTED[name]]
        assert pa <= s <= e <= pb, name
        assert t == thread, name
    assert all(x[2] <= y[1] for x, y in zip(nested, nested[1:]))
    assert _best_cover(call, outer_name, spans) >= COVER


@pytest.mark.parametrize("mask_stride", [1, 2])
def test_monolithic_round_waits_then_unpacks(tiny, mask_stride):
    """The monolithic round crops, repeats and casts its labels before the
    download, which `wait` covers; `unpack` still follows it, once, on
    the calling thread, and still closes the round. Frames cropped to 30
    x 44 (padded to 32 x 48), so that the crop has padding to drop."""
    cfg, model, ds, seq = tiny
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, round_segments=1, mask_stride=mask_stride))
    ev = Evaluator(cfg, model, device="cpu")
    frames = _u8(ds.images(seq))[:, :30, :44]
    st = ev.start_sequence(frames, 2)
    scr = ds.initial_scribbles(seq, 0).to_json()
    ev.run_round(st, scr, frames.shape[1:3], 2)     # first-call costs
    got = {}

    def call():
        got["masks"] = ev.run_round(st, scr, frames.shape[1:3], 2)

    spans, thread = _traced(call)
    names = [s[0] for s in spans if s[0] not in NESTED]
    assert names == ["manet.round"] + PHASES["run_round"][1]
    assert {s[3] for s in spans} == {thread}
    (_, a, b, _), = [s for s in spans if s[0] == "manet.round"]
    (_, u0, u1, _), = [s for s in spans if s[0] == "manet.round.unpack"]
    assert a <= u0 <= u1 <= b
    assert all(s[2] <= u0 for s in spans
               if s[0] not in ("manet.round", "manet.round.unpack"))
    assert got["masks"].shape == (frames.shape[0], 30, 44)
    assert got["masks"].dtype == np.int32


def test_annotate_off_is_the_shared_no_op(monkeypatch):
    def forbidden(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", forbidden)
    assert not torch._C._autograd._profiler_enabled()
    span = profiling.annotate("manet.round")
    assert span is profiling.NO_SPAN
    with span, profiling.annotate("manet.round.unpack"):
        pass
    assert profiling.annotate("x") is profiling.annotate("y")


def test_annotate_on_records_only_the_profiling_thread():
    """The profiler's state is thread-local: a span opened on another
    thread while the main thread profiles is the no-op, and absent from
    the trace."""
    seen = {}

    def other():
        seen["span"] = profiling.annotate("manet.other")
        with seen["span"]:
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("manet.main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert seen["span"] is profiling.NO_SPAN
    assert [s[0] for s in _spans(prof)] == ["manet.main"]


class _Event:
    """The reads `profile_round` makes of a profiler event."""

    def __init__(self, name, device, start, end, annotation=False):
        self._v = (name, device, start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


class _Profile:
    def __init__(self, events):
        self.profiler = types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: events))


def test_profile_round_reads_the_phase_spans(tiny):
    """`profile_round`'s reductions on a CPU trace of one round: the host
    ms of each phase span, and device busy as the union of intervals."""
    call = _call("run_round", tiny)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    ms = profile_round.phase_ms(prof)
    assert set(ms) == {"manet.round", STEP_SPAN} | set(PHASES["run_round"][1])
    assert sum(v for k, v in ms.items()
               if k != "manet.round" and k not in NESTED) <= ms["manet.round"]
    assert ms[STEP_SPAN] <= ms["manet.round.dispatch"]
    assert profile_round.device_intervals(prof) == []
    # a span's device-side shadow (on the card) is neither host time nor
    # device work
    host = _Event("manet.round.dispatch", DeviceType.CPU, 0, 3_000_000)
    shadow = _Event("manet.round.dispatch", DeviceType.CUDA, 1_000_000,
                    9_000_000, annotation=True)
    kernel = _Event("kernel", DeviceType.CUDA, 2_000_000, 4_000_000)
    fake = _Profile([host, shadow, kernel])
    assert profile_round.phase_ms(fake) == {"manet.round.dispatch": 3.0}
    assert profile_round.device_intervals(fake) == [(2_000_000, 4_000_000)]
    assert profile_round.union_ms([]) == 0.0
    # overlapping intervals count once; ns in, ms out
    assert profile_round.union_ms(
        [(0, 2_000_000), (1_000_000, 3_000_000), (5_000_000, 6_000_000)]
    ) == pytest.approx(4.0)


def test_batch_pieces_emit_their_spans(tiny):
    """`BatchPropagator`'s upload (one `manet.batch.encode` an encoder
    call, nested in it), dispatch (one `manet.batch.clip` a clip, nested
    in it, with one `manet.batch.head` for the clip's start and one a
    step, nested in the clip) and drain each record their span once, in
    order, on the calling thread; the clip spans cover most of the
    dispatch."""
    from cvpr2020_manet_tpu_torch.engine.propagate_batch import (
        BatchPropagator)
    cfg, model, ds, seq = tiny
    prop = BatchPropagator(cfg, model, ingest="yuv420", device="cpu")
    frames = np.stack([_u8(ds.images(seq))] * 2)
    first = np.stack([ds.gt_masks(seq)[0, ::4, ::4]] * 2).astype(np.int32)
    up = prop.host_frames(frames)
    nobj = np.array([2, 1])
    prop.propagate(frames, first, nobj)              # first-call costs

    def call():
        ex = prop.upload(up)
        prop.drain(*prop.dispatch(ex, first, nobj, frames.shape[:2]))

    spans, thread = _traced(call)
    heads = ["manet.batch.head"] * frames.shape[1]   # the start, T - 1 steps
    assert [s[0] for s in spans] == [
        "manet.batch.upload", "manet.batch.encode", "manet.batch.dispatch",
        "manet.batch.clip", *heads, "manet.batch.clip", *heads,
        "manet.batch.drain"]
    assert {s[3] for s in spans} == {thread}
    (_, ua, ub, _), (_, ea, eb, _) = spans[:2]
    assert ua <= ea <= eb <= ub
    (_, a, b, _), = [s for s in spans if s[0] == "manet.batch.dispatch"]
    clips = [s for s in spans if s[0] == "manet.batch.clip"]
    assert all(a <= s <= e <= b for _, s, e, _ in clips)
    for _, ca, cb, _ in clips:
        inside = [s for s in spans
                  if s[0] == "manet.batch.head" and ca <= s[1] <= s[2] <= cb]
        assert len(inside) == len(heads)
    assert spans[0][2] <= a and b <= spans[-1][1]
    assert sum(e - s for _, s, e, _ in clips) / (b - a) >= 0.5


@pytest.mark.parametrize("rounds", [2, 1])
def test_submit_scores_then_asks_the_robot(tiny, rounds):
    """`InteractiveSession.submit_masks` records `manet.session.submit`
    with `.score` then, where a next round follows, `.robot`, nested and
    on the calling thread."""
    from cvpr2020_manet_tpu_torch.interactive.session import (
        InteractiveSession)
    _, _, ds, seq = tiny
    sess = InteractiveSession(ds, max_interactions=rounds)
    assert sess.next()
    sess.get_scribbles()
    masks = np.zeros(ds.gt_masks(seq).shape, np.int32)
    spans, thread = _traced(lambda: sess.submit_masks(masks))
    names = [s[0] for s in spans]
    phases = ["manet.session.submit.score"] + (
        ["manet.session.submit.robot"] if rounds > 1 else [])
    assert names == ["manet.session.submit"] + phases
    (_, a, b, _), = [s for s in spans if s[0] == "manet.session.submit"]
    assert all(a <= s <= e <= b and t == thread for _, s, e, t in spans)
    assert len(sess.get_report()) == ds.gt_masks(seq).shape[0] * 2


def test_batch_and_submit_spans_are_off_without_a_profiler(tiny,
                                                           monkeypatch):
    """With no profiler running, neither the batch engine nor the session
    builds a `record_function`."""
    from cvpr2020_manet_tpu_torch.engine.propagate_batch import (
        BatchPropagator)
    from cvpr2020_manet_tpu_torch.interactive.session import (
        InteractiveSession)

    def forbidden(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", forbidden)
    cfg, model, ds, seq = tiny
    prop = BatchPropagator(cfg, model, device="cpu")
    frames = _u8(ds.images(seq))[None]
    first = ds.gt_masks(seq)[:1, ::4, ::4].astype(np.int32)
    labels = prop.propagate(frames, first, np.array([2]))
    sess = InteractiveSession(ds, max_interactions=2)
    assert sess.next()
    sess.get_scribbles()
    sess.submit_masks(labels[0])
    assert sess.next()
