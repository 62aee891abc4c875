"""The round's sweep steps, one captured CUDA graph per step shape.

A round's sweep (`Evaluator._sweep_impl`) runs T - 1 steps, each
`sweep_step`: the frame's conv0 contributions summed with the round's,
`MANet.propagate` with the frame's global map matched outside the loop,
and the softmax. A step enqueues about 150 kernels; at 480p on an H100
their enqueue took about 4 ms of host time a step against 2.3 ms of device
work, so the host set the round's pace.

`SweepSteps.run` steps a sweep. Where the sequence's tensors are on a
CUDA device (`captures`), it captures the step once per step shape, the
key (h, w, object bucket, dtype, device), and replays that graph for every
step of every round; elsewhere it calls `sweep_step` itself, step by step.

- Slots. A graph reads static tensors of its own: the frame's embedding,
  the previous frame's, the frame's stored global minima, its matched
  global map and its features' conv0 contribution, copied in before each
  replay; the memory's conv0 contribution and the object mask, copied in
  once a round; and the carry (the previous step's probabilities), which
  the graph itself overwrites with the step's probabilities, and which the
  runner resets to the interaction's where a sweep starts or turns. After
  each replay the step's probabilities and minima are copied out of the
  graph's memory, so that no state tensor aliases a slot. A replay costs
  the host 8 or 9 calls.
- Device. The warm-up, the capture, the slot copies and the replays run
  with the sequence's device current, and each device captures on a
  stream of its own: a capture on another device's stream would record
  none of the step's work.
- Capture. The step first runs once on the capture stream from the
  sweep's first inputs, as a warm-up (it builds the kernels, loads their
  libraries and has the cuDNN plans chosen); its output is dropped. Then
  the step is captured. A device's graphs share one memory pool: one
  replays at a time, and its outputs are copied out before the next.
- Launches. A capture runs nothing and a replay runs no Python: the
  launches that `build.LAUNCHES` counted over the capture are taken back
  out and added again at every replay, and the warm-up's are taken back
  too (neither is a step of a sweep), so that a graphed round counts what
  the same round run step by step counts.
- Spans. Each step is a `manet.round.step` span, each replay a
  `manet.round.replay` span inside it (`utils/profiling.annotate`: no-ops
  without a profiler).
"""

from __future__ import annotations

import torch

from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.utils.profiling import annotate

STEP_SPAN = "manet.round.step"
REPLAY_SPAN = "manet.round.replay"


def captures(device: torch.device) -> bool:
    """Whether a sweep on `device` replays captured steps: on CUDA."""
    return device.type == "cuda"


def sweep_step(model, feat_f, emb_f, emb_prev, gmap_f, gm_pre, carry,
               head_fp_f, head_mp, obj_valid):
    """One step: frame f's (probabilities (h, w, O), fused global map) from
    the previous frame's probabilities `carry`. `gm_pre` is the frame's
    global matching map, `head_fp_f` and `head_mp` the frame's and the
    round's conv0 contributions; `propagate` reads neither the matching
    reference nor the memory then, and of `feat_f` only its dtype."""
    logits, g_new = model.propagate(
        feat_f, emb_f, None, None, None, gmap_f, emb_prev, carry, None,
        obj_valid, gmap_override=gm_pre, head_pre=head_fp_f[None] + head_mp)
    return torch.softmax(logits, dim=-1), g_new


class StepGraph:
    """One captured step of a shape, its slots and the launches a replay
    counts. Built with the sequence's device current."""

    def __init__(self, model, feat, emb, gmap, gm_pre, head, frame,
                 prev_frame, pool, stream):
        self.emb_f = torch.empty_like(emb[0])
        self.emb_prev = torch.empty_like(emb[0])
        self.gmap_f = torch.empty_like(gmap[0])
        self.gm_pre = torch.empty_like(gm_pre[0])
        self.head_fp = torch.empty_like(head["head_fp"][0])
        self.head_mp = torch.empty_like(head["head_mp"])
        self.obj_valid = torch.empty_like(head["obj_valid"])
        self.carry = torch.empty_like(head["int_probs"])
        # propagate reads only the features' dtype: a one-element NaN
        # stand-in, so that a read would show
        feat_f = torch.full((), float("nan"), dtype=feat.dtype,
                            device=emb.device).expand(feat.shape[1:])
        self.start_round(head)
        self.load(emb, gmap, gm_pre, head, frame, prev_frame, 0)
        self.carry.copy_(head["int_probs"])
        before = dict(build.LAUNCHES)
        stream.wait_stream(torch.cuda.current_stream(emb.device))
        with torch.cuda.stream(stream):
            self._step(model, feat_f)
        torch.cuda.current_stream(emb.device).wait_stream(stream)
        warm = dict(build.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.g_new = self._step(model, feat_f)
        self.counted = {k: v - warm[k] for k, v in build.LAUNCHES.items()
                        if v != warm[k]}
        build.LAUNCHES.update(before)

    def _step(self, model, feat_f):
        """The step on the slots, its probabilities left in the carry. ->
        the fused global map."""
        probs, g_new = sweep_step(
            model, feat_f, self.emb_f, self.emb_prev, self.gmap_f,
            self.gm_pre, self.carry, self.head_fp, self.head_mp,
            self.obj_valid)
        self.carry.copy_(probs)
        return g_new

    def start_round(self, head) -> None:
        """The round's constants into their slots."""
        self.head_mp.copy_(head["head_mp"])
        self.obj_valid.copy_(head["obj_valid"])

    def load(self, emb, gmap, gm_pre, head, frame, prev_frame, j) -> None:
        """Step j's inputs into their slots."""
        f, p = int(frame[j]), int(prev_frame[j])
        self.emb_f.copy_(emb[f])
        self.emb_prev.copy_(emb[p])
        self.gmap_f.copy_(gmap[f])
        self.gm_pre.copy_(gm_pre[j])
        self.head_fp.copy_(head["head_fp"][f])

    def replay(self) -> None:
        with annotate(REPLAY_SPAN):
            self.graph.replay()
        for k, v in self.counted.items():
            build.LAUNCHES[k] += v


class SweepSteps:
    """Steps an Evaluator's sweeps; holds its captured steps by key, and
    each device's memory pool and capture stream."""

    def __init__(self, model):
        self.model = model
        self.graphs: dict[tuple, StepGraph] = {}
        self.capture: dict[torch.device, tuple] = {}

    @staticmethod
    def key(head: dict, emb: torch.Tensor) -> tuple:
        """(h, w, object bucket, dtype, device): one graph each."""
        return (*head["int_probs"].shape, emb.dtype, emb.device)

    def run(self, feat, emb, gmap, gm_pre, head, frame, prev_frame,
            fwd_len: int):
        """The sweep's steps j = 0 .. T - 2 over frames `frame[j]` from
        `prev_frame[j]`, the carry reset to the interaction's probabilities
        at j = 0 and j = `fwd_len`. -> (probabilities (T-1, h, w, O), fused
        global maps (T-1, h, w, O)), by step."""
        if not captures(emb.device):
            return self._direct(feat, emb, gmap, gm_pre, head, frame,
                                prev_frame, fwd_len)
        with torch.cuda.device(emb.device):
            return self._replayed(feat, emb, gmap, gm_pre, head, frame,
                                  prev_frame, fwd_len)

    def _direct(self, feat, emb, gmap, gm_pre, head, frame, prev_frame,
                fwd_len):
        int_probs = head["int_probs"]
        probs_seq, g_seq = [], []
        carry = int_probs
        for j in range(len(frame)):
            f = int(frame[j])
            if j == fwd_len:
                carry = int_probs
            with annotate(STEP_SPAN):
                carry, g_new = sweep_step(
                    self.model, feat[f], emb[f], emb[int(prev_frame[j])],
                    gmap[f], gm_pre[j], carry, head["head_fp"][f],
                    head["head_mp"], head["obj_valid"])
            probs_seq.append(carry)
            g_seq.append(g_new)
        return torch.stack(probs_seq), torch.stack(g_seq)

    def _replayed(self, feat, emb, gmap, gm_pre, head, frame, prev_frame,
                  fwd_len):
        int_probs = head["int_probs"]
        probs_seq = torch.empty_like(gm_pre, dtype=int_probs.dtype)
        g_seq = torch.empty_like(
            gm_pre, dtype=torch.promote_types(gm_pre.dtype, gmap.dtype))
        key = self.key(head, emb)
        graph = self.graphs.get(key)
        if graph is None:
            if emb.device not in self.capture:
                self.capture[emb.device] = (torch.cuda.graph_pool_handle(),
                                            torch.cuda.Stream(emb.device))
            graph = self.graphs[key] = StepGraph(
                self.model, feat, emb, gmap, gm_pre, head, frame,
                prev_frame, *self.capture[emb.device])
        else:
            graph.start_round(head)
        for j in range(len(frame)):
            with annotate(STEP_SPAN):
                graph.load(emb, gmap, gm_pre, head, frame, prev_frame, j)
                if j in (0, fwd_len):
                    graph.carry.copy_(int_probs)
                graph.replay()
                probs_seq[j].copy_(graph.carry)
                g_seq[j].copy_(graph.g_new)
        return probs_seq, g_seq
