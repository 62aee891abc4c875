"""Interactive rounds: one annotator in a closed loop.

A session is `Evaluator.start_sequence` on a video, then
`rounds_per_session` calls of `Evaluator.run_round`, one scribble JSON
each; the next session starts when the last round's label maps are on
the host. Sessions cycle through the workload's fixed list of videos
(frame and object counts), so every window sees the same mix of frame
buckets; the seed draws the frames, the annotated frame of each round,
the scribbles and the weights.

A round is timed from the call of `run_round` to its label maps on the
host. The check takes a sample of rounds drawn from the seed (a first and
a later round of the sessions that a traced run drives, a later round on
the longest video and one on the video with the most objects, and more
later rounds) and holds each against the reference's round from the same
inputs: the reference encodes the video itself, and a later round starts
from the state that the program handed on from the round before (its
masks, global-map minima and interaction memory). Each sampled round's
own answers and the whole state it hands on are held against the
reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from manet_bench import counting, synth
from manet_bench.common import (
    Cell, now, percentile, program_config, program_model, synchronize)
from manet_bench.judge import Tally, label_gaps
from manet_bench.reference.engine import (
    RoundState, encode, round_steps, run_round, upsampled_probs)
from manet_bench.reference.model import Ref, fp32_math
from manet_bench.tracing import Trace, profiler, span
from manet_bench.weights import make_weights


@dataclasses.dataclass
class Log:
    rounds: list = dataclasses.field(default_factory=list)
    starts: list = dataclasses.field(default_factory=list)
    kept: dict = dataclasses.field(default_factory=dict)
    embeddings: dict = dataclasses.field(default_factory=dict)
    failed: int = 0
    seconds: float = 0.0

    @property
    def requests(self) -> list:
        """The calls the log timed."""
        return self.rounds


class Traffic:
    def __init__(self, cell: Cell):
        self.cell = cell
        p = cell.workload["traffic"]
        self.videos = p["videos"]
        self.n_rounds = p["rounds_per_session"]
        self.trace_sessions = p["trace_sessions"]
        self.sample_spec = cell.workload["check"]
        self.dev = cell.device
        self.cfg = program_config(cell.config)
        self.backend = cell.config.get("matching_backend", "auto")

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
        c, dev = self.cell, self.dev
        t = now()
        self.weights = make_weights(c.config["model"], c.seed, dev)
        model = program_model(self.cfg, c.config, self.weights, dev)
        synchronize(dev)
        self.parts = {"weights_s": now() - t}
        t = now()
        self.ev = Evaluator(self.cfg, model, device=dev)
        size = tuple(self.cfg.eval.image_size)
        self.inputs = []
        for i, v in enumerate(self.videos):
            frames, labels = synth.make_video(c.seed, i, v["frames"], size,
                                              v["objects"], dev)
            r = synth.rng(c.seed, 3, i)
            rounds = []
            for k in range(self.n_rounds):
                frame = int(r.integers(v["frames"]))
                every = list(range(v["objects"] + 1))
                objs = every if k == 0 else sorted(r.choice(
                    every, size=min(2, len(every)), replace=False).tolist())
                js, drawn = synth.scribble_json(r, labels, frame, v["frames"],
                                                objs, v["name"])
                rounds.append((js, drawn, frame if drawn else 0))
            self.inputs.append((frames, rounds))
        self.sample = self._draw_sample()
        synchronize(dev)
        self.parts["inputs_s"] = now() - t
        t = now()
        # every (frame bucket, object count) of the list, a first and a
        # later round each
        seen = set()
        for i, v in enumerate(self.videos):
            key = (self.ev.frame_bucket(v["frames"]), v["objects"])
            if key not in seen:
                seen.add(key)
                self._session(i, 2, Log())
        synchronize(dev)
        self.parts["warm_s"] = now() - t

    def _draw_sample(self) -> set:
        """(session, round) pairs of the first `sample_sessions` sessions
        to check: a first and a later round of a session that a traced run
        drives, a later round of the longest of the videos and one of the
        video with the most objects, and `later_rounds` more later
        rounds."""
        r = synth.rng(self.cell.seed, 4)
        n = min(len(self.videos), self.sample_spec["sample_sessions"])
        traced = min(n, self.trace_sessions)
        longest = max(range(n), key=lambda i: self.videos[i]["frames"])
        most = max(range(n), key=lambda i: self.videos[i]["objects"])
        out = {(int(r.integers(traced)), 0)}
        later = [(i, k) for i in range(n) for k in range(1, self.n_rounds)]
        if later:
            for i in (int(r.integers(traced)), longest, most):
                out.add((i, int(r.integers(1, self.n_rounds))))
            rest = [p for p in later if p not in out]
            pick = r.choice(len(rest), size=min(len(rest),
                                                self.sample_spec["later_rounds"]),
                            replace=False)
            out.update(rest[j] for j in pick)
        return out

    # ------------------------------------------------------------ traffic

    def _session(self, k: int, n_rounds: int, log: Log, deadline=None,
                 traced: bool = False) -> None:
        from cvpr2020_manet_tpu_torch.engine.evaluator import release_state
        i = k % len(self.videos)
        v = self.videos[i]
        frames, rounds = self.inputs[i]
        hw = frames.shape[1:3]
        t0 = now()
        with span("bench.start_sequence"):
            st = self.ev.start_sequence(frames, v["objects"])
            if traced:
                synchronize(self.dev)
        log.starts.append({"seconds": now() - t0, "frames": v["frames"]})
        if any(key[0] == k for key in self.sample):
            log.embeddings[k] = st.emb
        for r in range(n_rounds):
            js = rounds[r][0]
            keep = (k, r) in self.sample
            before = (st.prev_masks, st.gmap_mem, st.int_mem) if keep else None
            t0 = now()
            try:
                with span("bench.round"):
                    masks = self.ev.run_round(st, js, hw, v["objects"])
            except RuntimeError:
                log.failed += 1
                break
            t1 = now()
            log.rounds.append({"seconds": t1 - t0, "end": t1,
                               "frames": v["frames"], "objects": v["objects"],
                               "bucket": st.feat.shape[0]})
            if keep:
                log.kept[(k, r)] = {"masks": masks, "before": before,
                                    "after": (st.prev_masks, st.gmap_mem,
                                              st.int_mem)}
            if deadline is not None and t1 >= deadline:
                break
        release_state(st)

    def window(self, seconds: float) -> Log:
        log = Log()
        start = now()
        k = 0
        while now() < start + seconds:
            self._session(k, self.n_rounds, log, deadline=start + seconds)
            k += 1
        log.seconds = log.rounds[-1]["end"] - start
        return log

    def end_to_end(self, log: Log) -> dict:
        lat = [r["seconds"] for r in log.rounds]
        return {"round_p90_ms": percentile(lat, 90) * 1e3,
                "frames_per_s": sum(r["frames"] for r in log.rounds)
                / log.seconds}

    def traced(self) -> tuple[Log, Trace]:
        """The first `trace_sessions` sessions, untraced for their wall and
        then again under the profiler."""
        untraced = Log()
        t0 = now()
        for k in range(self.trace_sessions):
            self._session(k, self.n_rounds, untraced)
        synchronize(self.dev)
        wall = now() - t0
        log = Log()
        with profiler(self.dev) as prof:
            with span("bench.window"):
                for k in range(self.trace_sessions):
                    self._session(k, self.n_rounds, log, traced=True)
                synchronize(self.dev)
        log.seconds = wall
        return log, Trace.from_profiler(prof, self._work(log, wall))

    def _work(self, log: Log, wall: float) -> dict:
        """What the traced slice asked of the device: each kernel's work
        and the model's FLOPs."""
        m = self.cell.config["model"]
        hp, wp = (x + (-x) % self.cfg.eval.pad_to
                  for x in self.cfg.eval.image_size)
        h, w = hp // 4, wp // 4
        c, s = m["embedding_dim"], m["local_downsample"]
        fl = counting.model_flops(m, (hp, wp))
        gm, lm = counting.Work(), counting.Work()
        flops = sum(fl["encoder_frame"] * st["frames"] for st in log.starts)
        for i, r in enumerate(log.rounds):
            o, steps = r["objects"] + 1, r["frames"] - 1
            g = counting.global_matching(steps * h * w, h * w, c, o,
                                         "int8" if self.backend == "int8"
                                         else "bf16")
            loc = counting.local_matching(h // s, w // s, c, o,
                                          m["local_window"])
            gm += g
            for _ in range(steps):
                lm += loc
            first = i % self.n_rounds == 0
            flops += o * (fl["interact_object"]
                          + (0 if first else fl["gate_object"])
                          + steps * fl["head_object"])
            flops += g.ops + steps * loc.ops
        return {"kernels": {"global_matching": gm, "local_matching": lm},
                "flops": flops, "wall_s": wall,
                "rounds": len(log.rounds), "starts": log.starts}

    # ------------------------------------------------------------- check

    def free_program(self) -> None:
        self.ev = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, log: Log, control: bool = False) -> dict:
        """The readings of the program's sampled rounds, and with
        `control` those of the control (the reference one step lower in
        precision, from the same state) in the program's place. Each is
        held against the reference stage by stage (`round_steps`): the
        encoder's embeddings, the interaction, and every sweep step from
        the candidate's own previous frame; and the state it hands on: the
        masks, the global-map minima and the interaction memory."""
        m = self.cell.config["model"]
        backend = "int8" if self.backend == "int8" else "bf16"
        ref = Ref(self.weights, m, matching=backend)
        low = Ref(self.weights, m, matching=backend, low=True)
        tallies = {"program": Tally()}
        if control:
            tallies["control"] = Tally()
        pad_to, stride = self.cfg.eval.pad_to, m["feature_stride"]
        encoded: dict = {}
        with fp32_math(), torch.no_grad():
            for (k, r), kept in sorted(log.kept.items()):
                i = k % len(self.videos)
                v = self.videos[i]
                frames, rounds = self.inputs[i]
                _, drawn, annot = rounds[r]
                nf, n = v["frames"], v["objects"]
                hw = frames.shape[1:3]
                raster = torch.from_numpy(
                    synth.raster(drawn, hw, pad_to)).to(self.dev)
                size = tuple(raster.shape)
                if encoded.get("video") != i:
                    encoded = {"video": i, "ref": encode(ref, frames, pad_to,
                                                         self.dev)}
                    if control:
                        encoded["control"] = encode(low, frames, pad_to,
                                                    self.dev)
                feat, emb = encoded["ref"]
                probs0, gmap0, mem0 = kept["before"]
                before = (RoundState.initial(nf, *feat.shape[1:3],
                                             probs0.shape[-1], self.dev)
                          if r == 0 else
                          RoundState(probs0[:nf].float(), gmap0[:nf].float(),
                                     mem0.permute(0, 3, 1, 2).float(), False))
                for name, tally in tallies.items():
                    if name == "program":
                        labels = torch.from_numpy(kept["masks"]).to(self.dev)
                        probs, gmap, mem = kept["after"]
                        probs, gmap = probs[:nf].float(), gmap[:nf].float()
                        mem = mem.permute(0, 3, 1, 2).float()
                        cand_emb = log.embeddings[k][:nf, ..., :emb.shape[-1]]
                    else:
                        cf, cand_emb = encoded["control"]
                        probs, gmap, mem = run_round(
                            low, cf, cand_emb, before, raster, annot, n, nf,
                            stride)
                        labels = upsampled_probs(probs, size)[
                            :, :hw[0], :hw[1]].argmax(-1)
                    ref_p, ref_g, ref_m = round_steps(
                        ref, feat, emb, before, probs, raster, annot, n, nf,
                        stride)
                    for f in range(nf):
                        up = upsampled_probs(ref_p[f], size)[:hw[0], :hw[1]]
                        tally.add("label_gap", label_gaps(up, labels[f]))
                    tally.add("state_gap", label_gaps(ref_p, probs.argmax(-1)))
                    # the minima this round lowered on either side: where
                    # both keep the state's value the two are equal
                    moved = (gmap < gmap0[:nf]) | (ref_g < gmap0[:nf])
                    if moved.any():
                        tally.add("gmap_err", (gmap - ref_g)[moved].abs())
                    tally.add_relative("int_mem_err", mem, ref_m)
                    tally.add_relative("emb_err", cand_emb.float(), emb)
        return {k: t.numbers() for k, t in tallies.items()}
