"""A live stream: one camera feed segmented frame by frame after a few
corrections.

Set-up resets a `StreamingIVOS` for the workload's objects, then, for
each of `corrections` frames of a seeded pool of uint8 RGB frames,
observes it and corrects it with scribbles drawn on the frame's seeded
labels, which fills that many pages of matching memory. The window is a
closed loop of `observe` over the pool (in order, cycling), with no
correction inside it; each call is timed from the uint8 frame handed in
to its label map on the host.

The check replays the set-up on the reference (every observe and
correction, from the same frames and scribbles) and holds the program's
answers there against it; then, for a sample of the window's frames drawn
from the seed (the first one always), the reference segments the frame
from its own memory and the frame before, continuing from the
probabilities that the program handed on from that frame, and holds the
program's answer and the probabilities it hands on against its own.
"""

from __future__ import annotations

import dataclasses

import torch

from manet_bench import counting, synth
from manet_bench.common import (
    Cell, now, percentile, program_config, program_model, synchronize)
from manet_bench.judge import Tally, label_gaps
from manet_bench.reference.engine import (
    StreamState, encode, stream_correct, stream_observe, upsampled_probs)
from manet_bench.reference.model import Ref, fp32_math
from manet_bench.tracing import Trace, profiler, span
from manet_bench.weights import make_weights


@dataclasses.dataclass
class Log:
    frames: list = dataclasses.field(default_factory=list)
    kept: dict = dataclasses.field(default_factory=dict)
    failed: int = 0
    seconds: float = 0.0

    @property
    def requests(self) -> list:
        """The calls the log timed."""
        return self.frames


class Traffic:
    def __init__(self, cell: Cell):
        self.cell = cell
        p = cell.workload["traffic"]
        self.pool = p["pool_frames"]
        self.objects = p["objects"]
        self.corrections = p["corrections"]
        self.trace_frames = p["trace_frames"]
        self.spec = cell.workload["check"]
        self.dev = cell.device
        self.cfg = program_config(cell.config)
        self.backend = cell.config.get("matching_backend", "auto")

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from cvpr2020_manet_tpu_torch.engine.streaming import StreamingIVOS
        c, dev = self.cell, self.dev
        t = now()
        self.weights = make_weights(c.config["model"], c.seed, dev)
        model = program_model(self.cfg, c.config, self.weights, dev)
        synchronize(dev)
        self.parts = {"weights_s": now() - t}
        t = now()
        self.s = StreamingIVOS(self.cfg, model, device=dev)
        size = tuple(self.cfg.eval.image_size)
        self.frames, labels = synth.make_video(c.seed, 0, self.pool, size,
                                               self.objects, dev)
        r = synth.rng(c.seed, 5)
        synchronize(dev)
        self.parts["inputs_s"] = now() - t
        t = now()
        self.s.reset(self.objects)
        # (kind, frame or strokes, program's answer)
        self.setup_events = []
        every = list(range(self.objects + 1))
        for j in range(self.corrections):
            self._setup_observe(j)
            objs = every if j == 0 else sorted(r.choice(
                every, size=min(2, len(every)), replace=False).tolist())
            js, drawn = synth.scribble_json(r, labels[j:j + 1], 0, 1, objs,
                                            "stream")
            mask = self.s.correct(js)
            self.setup_events.append(("correct", drawn, mask,
                                      self.s.state["cur_probs"]))
        self.pos = self.corrections
        r = synth.rng(c.seed, 6)
        n = self.spec["sample_from_first"]
        self.sample = {0} | set(r.choice(
            range(1, n), size=min(n - 1, self.spec["sample_frames"] - 1),
            replace=False).tolist())
        # the window's shapes: two observes from the corrected state
        self._setup_observe(self.pos)
        self._setup_observe(self.pos + 1)
        self.pos += 2
        self.pages = self.s.state["mem_onehot"]
        self.o_bucket = self.s.state["obj_valid"].shape[0]
        synchronize(dev)
        self.parts["corrections_and_warm_s"] = now() - t

    def _setup_observe(self, f: int) -> None:
        mask = self.s.observe(self.frames[f])
        self.setup_events.append(("observe", f, mask,
                                  self.s.state["prev_probs"]))

    # ------------------------------------------------------------ traffic

    def _observe(self, idx: int, log: Log, keep: bool) -> float:
        f = self.pos % self.pool
        prev = (self.pos - 1) % self.pool
        st = self.s.state
        before = st["prev_probs"] if keep else None
        t0 = now()
        try:
            with span("bench.observe"):
                mask = self.s.observe(self.frames[f])
        except RuntimeError:
            log.failed += 1
            return now()
        t1 = now()
        self.pos += 1
        log.frames.append({"seconds": t1 - t0, "end": t1})
        if keep:
            log.kept[idx] = {"frame": f, "prev": prev, "mask": mask,
                             "before": before, "after": st["prev_probs"],
                             "emb": st["prev_emb"]}
        return t1

    def window(self, seconds: float) -> Log:
        log = Log()
        start = now()
        t, i = start, 0
        while t < start + seconds:
            t = self._observe(i, log, i in self.sample)
            i += 1
        log.seconds = log.frames[-1]["end"] - start
        return log

    def end_to_end(self, log: Log) -> dict:
        lat = [f["seconds"] for f in log.frames]
        return {"frame_p95_ms": percentile(lat, 95) * 1e3,
                "frames_per_s": len(lat) / log.seconds}

    def traced(self) -> tuple[Log, Trace]:
        """`trace_frames` observes untraced for their wall, then the next
        as many under the profiler."""
        t0 = now()
        for i in range(self.trace_frames):
            self._observe(i, Log(), False)
        synchronize(self.dev)
        wall = now() - t0
        log = Log()
        with profiler(self.dev) as prof:
            with span("bench.window"):
                for i in range(self.trace_frames):
                    self._observe(i, log, i in self.sample)
                synchronize(self.dev)
        log.seconds = wall
        return log, Trace.from_profiler(prof, self._work(log, wall))

    def _work(self, log: Log, wall: float) -> dict:
        m = self.cell.config["model"]
        h, w = self.s.hh, self.s.ww
        c, s = m["embedding_dim"], m["local_downsample"]
        o = self.objects + 1
        fl = counting.model_flops(m, (self.s.hp, self.s.wp))
        g = counting.global_matching(h * w, self.corrections * h * w, c, o,
                                     "int8" if self.backend == "int8"
                                     else "bf16")
        loc = counting.local_matching(h // s, w // s, c, o, m["local_window"])
        gm, lm = counting.Work(), counting.Work()
        for _ in log.frames:
            gm += g
            lm += loc
        n = len(log.frames)
        flops = n * (fl["encoder_frame"] + o * fl["head_object"] + g.ops
                     + loc.ops)
        key = "global_matching_int8" if self.backend == "int8" \
            else "global_matching"
        return {"kernels": {key: gm, "local_matching": lm}, "flops": flops,
                "wall_s": wall, "frames": n}

    # ------------------------------------------------------------- check

    def free_program(self) -> None:
        self.s = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, log: Log, control: bool = False) -> dict:
        """The program's answers, and with `control` the control's (the
        reference one step lower in precision running the same set-up),
        held against the reference call by call: each set-up call and
        each sampled frame from the candidate's own state before it (its
        probabilities, and its memory pages' labels) and the reference's
        own features, embeddings and interaction memory."""
        m = self.cell.config["model"]
        backend = "int8" if self.backend == "int8" else "bf16"
        ref = Ref(self.weights, m, matching=backend)
        pad_to, stride = self.cfg.eval.pad_to, m["feature_stride"]
        size = tuple(self.frames.shape[1:3])
        hp, wp = (x + (-x) % pad_to for x in size)
        hw = (hp // stride) * (wp // stride)
        o = self.o_bucket
        obj_valid = (torch.arange(o, device=self.dev)
                     <= self.objects).float()

        def enc(model, f):
            feat, emb = encode(model, self.frames[f:f + 1], pad_to, self.dev)
            return feat[0], emb[0]

        def answer(probs):
            return upsampled_probs(probs, (hp, wp))[:size[0], :size[1]]

        def replay(model, given=None, pages=None):
            """The set-up's calls on `model`; with `given` (each call's
            probabilities from a candidate) and `pages` (its memory's
            labels), each call starts from the candidate's state. ->
            (each call's probabilities, the memory, each call's
            embedding)."""
            st = StreamState([], [], None)
            outs, embs = [], []
            n_pages = 0
            for j, (kind, arg, _, _) in enumerate(self.setup_events):
                if kind == "observe":
                    feat, emb = enc(model, arg)
                    probs = stream_observe(model, feat, emb, st, st.emb,
                                           st.probs, obj_valid)
                    st.feat, st.emb = feat, emb
                else:
                    raster = torch.from_numpy(synth.raster(
                        arg, size, pad_to)).to(self.dev)
                    labels = None if pages is None else \
                        pages[n_pages * hw:(n_pages + 1) * hw].argmax(-1)
                    probs = stream_correct(model, st, raster, obj_valid,
                                           stride, key_labels=labels)
                    n_pages += 1
                st.probs = probs if given is None else given[j]
                outs.append(probs)
                embs.append(st.emb)
            return outs, st, embs

        with fp32_math(), torch.no_grad():
            cands = {"program": (
                [e[3].float() for e in self.setup_events],
                [torch.from_numpy(e[2]).to(self.dev)
                 for e in self.setup_events], self.pages)}
            if control:
                low = Ref(self.weights, m, matching=backend, low=True)
                outs, low_state, _ = replay(low)
                cands["control"] = (outs, [answer(p).argmax(-1)
                                           for p in outs],
                                    torch.cat(low_state.labels))
            out = {}
            for name, (given, answers, pages) in cands.items():
                pages_oh = pages if pages.ndim == 2 else \
                    torch.nn.functional.one_hot(pages, o)
                t = Tally()
                ref_outs, st, _ = replay(ref, given, pages_oh)
                for rp, p, a in zip(ref_outs, given, answers):
                    t.add("label_gap", label_gaps(answer(rp), a))
                    t.add("state_gap", label_gaps(rp, p.argmax(-1)))
                for idx, kept in sorted(log.kept.items()):
                    feat, emb = enc(ref, kept["frame"])
                    _, prev_emb = enc(ref, kept["prev"])
                    rp = stream_observe(ref, feat, emb, st, prev_emb,
                                        kept["before"].float(), obj_valid)
                    if name == "program":
                        p = kept["after"].float()
                        a = torch.from_numpy(kept["mask"]).to(self.dev)
                        e = kept["emb"][..., :emb.shape[-1]].float()
                    else:
                        lf, le = enc(low, kept["frame"])
                        _, lpe = enc(low, kept["prev"])
                        p = stream_observe(low, lf, le, low_state, lpe,
                                           kept["before"].float(), obj_valid)
                        a, e = answer(p).argmax(-1), le
                    t.add("label_gap", label_gaps(answer(rp), a))
                    t.add("state_gap", label_gaps(rp, p.argmax(-1)))
                    t.add_relative("emb_err", e, emb)
                out[name] = t.numbers()
        return out
