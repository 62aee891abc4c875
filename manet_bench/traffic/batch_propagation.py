"""Offline propagation of first-frame masks through a video corpus, a
batch of clips at a time.

Set-up makes a pool of clips from the seed (frames, the first frame's
labels; lengths and object counts from the workload's list), groups them
into batches of `batch` clips in order, pads each clip to its batch's
longest by repeating its last frame (only real frames count), and turns
the frames into planar YUV 4:2:0 on the host, as a decoder would hand
them over; then it runs every batch once, which warms every shape.

The window is `BatchPropagator`'s pipelined schedule over the batches,
cycling: batch i's `dispatch`, then batch i+1's `upload` (one upload
thread), then batch i's `drain`; batch 0's upload is inside the clock. A
batch counts when its labels are on the host.

The check takes a sample of clips from the seed (always the one with the
most objects), each at its first propagated frame, a middle one, its
last real frame and one drawn from the seed. The first time a sampled
clip's batch runs, the same `dispatch` call hands back that clip's
probabilities and seeded memory; the reference then steps each sampled
frame from the program's own probabilities of the frame before, with its
own features, embeddings and memory, and holds the program's labels, the
probabilities it computed, its embeddings and its memory against its
own.
"""

from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import torch

from manet_bench import counting, synth
from manet_bench.common import (
    Cell, now, program_config, program_model, synchronize)
from manet_bench.judge import Tally, label_gaps
from manet_bench.reference import batch as rb
from manet_bench.reference.engine import upsampled_probs
from manet_bench.reference.model import Ref, fp32_math
from manet_bench.tracing import Trace, profiler, span
from manet_bench.weights import make_weights

@dataclasses.dataclass
class Log:
    clips: list = dataclasses.field(default_factory=list)
    batches: list = dataclasses.field(default_factory=list)
    kept: dict = dataclasses.field(default_factory=dict)
    failed: int = 0
    seconds: float = 0.0

    @property
    def requests(self) -> list:
        """The clips whose labels the log saw reach the host."""
        return self.clips


class Traffic:
    def __init__(self, cell: Cell):
        self.cell = cell
        p = cell.workload["traffic"]
        self.clip_spec = p["clips"]
        self.batch = p["batch"]
        self.ingest = p["ingest"]
        self.threads = p["upload_threads"]
        self.trace_batches = p["trace_batches"]
        self.spec = cell.workload["check"]
        self.dev = cell.device
        self.cfg = program_config(cell.config)
        self.backend = cell.config.get("matching_backend", "auto")

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from cvpr2020_manet_tpu_torch.engine.propagate_batch import (
            BatchPropagator)
        if "probs_of" not in inspect.signature(
                BatchPropagator.dispatch).parameters:
            raise RuntimeError("BatchPropagator.dispatch hands back no "
                               "state (no `probs_of`): this program cannot "
                               "run the cell's check")
        c, dev = self.cell, self.dev
        t = now()
        self.weights = make_weights(c.config["model"], c.seed, dev)
        model = program_model(self.cfg, c.config, self.weights, dev)
        synchronize(dev)
        self.parts = {"weights_s": now() - t}
        t = now()
        self.prop = BatchPropagator(self.cfg, model, ingest=self.ingest,
                                    device=dev)
        self._make_inputs()
        self.sample = self._draw_sample()
        synchronize(dev)
        self.parts["inputs_s"] = now() - t
        t = now()
        for k in range(len(self.batches)):
            self._pipelined(k, self._upload(k), Log(), None)
        synchronize(dev)
        self.parts["warm_s"] = now() - t

    def _make_inputs(self) -> None:
        """self.clips: per clip its real frames in the upload format (on
        the host), its first mask (h, w) and object count; self.batches:
        per batch its clip indices, its upload input and its first masks,
        object counts and (B, T)."""
        c, s = self.cell, self.cfg.model.feature_stride
        size = tuple(self.cfg.eval.image_size)
        self.clips = []
        for i, v in enumerate(self.clip_spec):
            rgb, lab = synth.make_video(c.seed, i, v["frames"], size,
                                        v["objects"], self.dev)
            first = lab[0, ::s, ::s].astype(np.int32)
            if self.ingest == "yuv420":
                y, uv = rb.rgb_to_yuv420(torch.from_numpy(rgb).to(self.dev))
                frames = (y.cpu().numpy(), uv.cpu().numpy())
            else:
                frames = rgb
            self.clips.append({"frames": frames, "first": first,
                               "objects": v["objects"], "n": v["frames"]})
        self.batches = []
        for b0 in range(0, len(self.clips), self.batch):
            idx = list(range(b0, min(b0 + self.batch, len(self.clips))))
            t = max(self.clips[i]["n"] for i in idx)
            parts = [self._padded(self.clips[i]["frames"], t) for i in idx]
            if self.ingest == "yuv420":
                up = tuple(np.ascontiguousarray(np.concatenate(
                    [p[j] for p in parts])) for j in range(2))
            else:
                up = np.ascontiguousarray(np.concatenate(parts))
            self.batches.append({
                "clips": idx, "upload": up, "shape": (len(idx), t),
                "first": np.stack([self.clips[i]["first"] for i in idx]),
                "objects": np.asarray([self.clips[i]["objects"]
                                       for i in idx], np.int32),
                "frames": sum(self.clips[i]["n"] for i in idx)})

    @staticmethod
    def _padded(frames, t: int):
        """A clip's frames padded to `t` by repeating its last frame."""
        def pad(a):
            extra = t - a.shape[0]
            return np.concatenate([a, np.repeat(a[-1:], extra, 0)]) \
                if extra else a
        return tuple(pad(a) for a in frames) if isinstance(frames, tuple) \
            else pad(frames)

    def _draw_sample(self) -> dict:
        """clip -> the frames to check: the clip with the most objects and
        `sample_clips` - 1 more from the seed, each at its first
        propagated frame, a middle one, its last real frame and one drawn
        from the seed."""
        r = synth.rng(self.cell.seed, 7)
        n = len(self.clips)
        most = max(range(n), key=lambda i: self.clips[i]["objects"])
        rest = [i for i in range(n) if i != most]
        pick = r.choice(len(rest), size=min(len(rest),
                                            self.spec["sample_clips"] - 1),
                        replace=False)
        out = {}
        for i in sorted([most, *(rest[j] for j in pick)]):
            last = self.clips[i]["n"] - 1
            if last < 1:
                continue
            out[i] = sorted({1, max(1, last // 2), last,
                             int(r.integers(1, last + 1))})
        return out

    # ------------------------------------------------------------ traffic

    def _upload(self, k: int):
        b = self.batches[k % len(self.batches)]
        return self.prop.upload(b["upload"], threads=self.threads)

    def _pipelined(self, k: int, ex, log: Log, deadline, keep=False):
        """Batch k's dispatch, the next batch's upload (unless the
        deadline has passed), batch k's drain. -> the next batch's
        upload, or None."""
        b = self.batches[k % len(self.batches)]
        want = [j for j, i in enumerate(b["clips"])
                if keep and i in self.sample and i not in log.kept]
        t0 = now()
        nxt = None
        try:
            with span("bench.batch"):
                if want:
                    fetches, bits, state = self.prop.dispatch(
                        ex, b["first"], b["objects"], b["shape"],
                        probs_of=want)
                    embs = self._embeddings(ex, b, want)
                else:
                    fetches, bits = self.prop.dispatch(
                        ex, b["first"], b["objects"], b["shape"])
                del ex
                if deadline is None or now() < deadline:
                    nxt = self._upload(k + 1)
                labels = self.prop.drain(fetches, bits)
        except RuntimeError:
            log.failed += len(b["clips"])
            return nxt
        t1 = now()
        log.batches.append({"seconds": t1 - t0, "end": t1,
                            "frames": b["frames"], "clips": b["clips"]})
        for i in b["clips"]:
            log.clips.append({"clip": i, "end": t1,
                              "frames": self.clips[i]["n"]})
        for j in want:
            i = b["clips"][j]
            ts = self.sample[i]
            log.kept[i] = {"probs": state[j]["probs"],
                           "int_mem": state[j]["int_mem"],
                           "labels": {t: labels[j, t].copy() for t in ts},
                           "emb": embs[j]}
        return nxt

    def _embeddings(self, ex, b: dict, want) -> dict:
        """The program's embeddings of the sampled frames of the clips at
        positions `want` of batch `b`, copied from the upload's chunks of
        8 frames."""
        chunk, t = ex[0][1].shape[0], b["shape"][1]
        out = {}
        for j in want:
            out[j] = {}
            for f in self.sample[b["clips"][j]]:
                row = j * t + f
                out[j][f] = ex[row // chunk][1][row % chunk].clone()
        return out

    def window(self, seconds: float) -> Log:
        log = Log()
        start = now()
        deadline = start + seconds
        k, ex = 0, self._upload(0)
        while ex is not None:
            ex = self._pipelined(k, ex, log, deadline, keep=True)
            k += 1
        log.seconds = log.batches[-1]["end"] - start
        return log

    def end_to_end(self, log: Log) -> dict:
        return {"frames_per_s": sum(b["frames"] for b in log.batches)
                / log.seconds}

    def traced(self) -> tuple[Log, Trace]:
        """`trace_batches` batches in the pipelined order, untraced for
        their wall, then again under the profiler; each batch's span
        holds its dispatch, the next batch's upload and its drain."""
        t0 = now()
        ex = self._upload(0)
        for k in range(self.trace_batches):
            ex = self._pipelined(k, ex, Log(), None)
        synchronize(self.dev)
        wall = now() - t0
        del ex
        log = Log()
        with profiler(self.dev) as prof:
            with span("bench.window"):
                ex = self._upload(0)
                for k in range(self.trace_batches):
                    ex = self._pipelined(k, ex, log, None, keep=True)
                synchronize(self.dev)
        del ex
        log.seconds = wall
        return log, Trace.from_profiler(prof, self._work(log, wall))

    def _work(self, log: Log, wall: float) -> dict:
        """What the traced batches asked of the device, at real frames and
        labelled keys: each kernel's work and the model's FLOPs."""
        m = self.cell.config["model"]
        hp, wp = self.cfg.eval.image_size
        s = m["feature_stride"]
        h, w = hp // s, wp // s
        c, ds = m["embedding_dim"], m["local_downsample"]
        fl = counting.model_flops(m, (hp, wp))
        gm, lm = counting.Work(), counting.Work()
        flops = 0.0
        for b in log.batches:
            for i in b["clips"]:
                n, o = self.clips[i]["n"], self.clips[i]["objects"] + 1
                g = counting.global_matching((n - 1) * h * w, h * w, c, o,
                                             "int8" if self.backend == "int8"
                                             else "bf16")
                loc = counting.local_matching(h // ds, w // ds, c, o,
                                              m["local_window"])
                gm += g
                for _ in range(n - 1):
                    lm += loc
                flops += (n * fl["encoder_frame"] + o * fl["interact_object"]
                          + (n - 1) * (o * fl["head_object"] + loc.ops)
                          + g.ops)
        return {"kernels": {"global_matching": gm, "local_matching": lm},
                "flops": flops, "wall_s": wall,
                "batches": [b["frames"] for b in log.batches]}

    # ------------------------------------------------------------- check

    def free_program(self) -> None:
        self.prop = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _frames(self, i: int):
        """Clip i's real frames on the device, in the upload format."""
        fr = self.clips[i]["frames"]
        if isinstance(fr, tuple):
            return tuple(torch.from_numpy(a).to(self.dev) for a in fr)
        return torch.from_numpy(fr).to(self.dev)

    def check(self, log: Log, control: bool = False) -> dict:
        """The program's sampled frames, and with `control` those of the
        control (the reference one step lower in precision propagating
        the clip itself from its first mask) in the program's place, each
        held against the reference step by step: every sampled frame from
        the candidate's own probabilities of the frame before, with the
        reference's own features, embeddings and seeded memory."""
        m = self.cell.config["model"]
        backend = "int8" if self.backend == "int8" else "bf16"
        ref = Ref(self.weights, m, matching=backend)
        s = m["feature_stride"]
        tallies = {"program": Tally()}
        if control:
            tallies["control"] = Tally()
            low = Ref(self.weights, m, matching=backend, low=True)
        with fp32_math(), torch.no_grad():
            for i, kept in sorted(log.kept.items()):
                clip = self.clips[i]
                ts = self.sample[i]
                frames = self._frames(i)
                first = torch.from_numpy(clip["first"]).to(self.dev)
                o = kept["probs"].shape[-1]
                ov = rb.object_valid(clip["objects"], o, self.dev)
                need = sorted({0, *ts, *(t - 1 for t in ts)})
                feat, emb = rb.encode_frames(ref, frames, need)
                at = {t: j for j, t in enumerate(need)}
                mem = rb.seed_memory(ref, feat[0], first, ov)
                labels0 = rb.key_labels(first, ov)
                cands = {"program": (kept["probs"].float(), kept["labels"],
                                     kept["emb"], kept["int_mem"].permute(
                                         0, 3, 1, 2).float())}
                if control:
                    p, e, cm = rb.propagate_clip(low, frames, first,
                                                 clip["objects"], o,
                                                 last=max(ts))
                    size = (p.shape[1] * s, p.shape[2] * s)
                    cands["control"] = (
                        p, {t: upsampled_probs(p[t], size).argmax(-1)
                            for t in ts}, {t: e[t] for t in ts}, cm)
                for name, (probs, labs, embs, cmem) in cands.items():
                    tally = tallies[name]
                    tally.add_relative("int_mem_err", cmem, mem)
                    for t in ts:
                        rp = rb.step(ref, feat[at[t]], emb[at[t]], emb[0],
                                     labels0, emb[at[t - 1]], probs[t - 1],
                                     mem, ov)
                        lab = torch.as_tensor(labs[t], device=self.dev)
                        up = upsampled_probs(rp, tuple(lab.shape))
                        tally.add("label_gap", label_gaps(up, lab))
                        tally.add("state_gap",
                                  label_gaps(rp, probs[t].argmax(-1)))
                        tally.add_relative(
                            "emb_err", embs[t][..., :emb.shape[-1]].float(),
                            emb[at[t]])
        return {k: t.numbers() for k, t in tallies.items()}
