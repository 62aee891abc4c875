"""Offline first-frame propagation with FEELVOS (the port's
`models/feelvos.py`) through `BatchPropagator`, a batch of clips at a
time: the `batch_propagation` traffic's set-up, schedule and sample, with
FEELVOS's weights, work counts and reference.

Set-up draws the reference's parameters from the seed and calibrates
their frozen norms on a seeded two-frame clip
(`weights_feelvos.make_weights`), loads them into the program's FEELVOS
by name, then makes the pool of clips and warms every shape as
`batch_propagation` does. The window is its pipelined schedule, cycling:
batch i's `dispatch`, batch i+1's `upload`, batch i's `drain`; a batch
counts when its labels are on the host, by its real frames.

The traced slice records, beside `batch_propagation`'s, the program's
`manet.batch.encode` and `manet.batch.head` spans with each launch tied
to its kernel (`span_kernels.SpanTrace`), and hands the readers the
least times of the encoder work of every upload in the slice and of the
head work of its real propagated frames and live objects
(`counting_feelvos.py`), and the model FLOPs of both and of matching.

The check: for each sampled clip (always the one with the most objects)
and frame, the program's probabilities of the frame before step the
plain reference (`reference/feelvos.py`) with its own features and
embeddings; the program's labels and probabilities are held against the
reference's (`label_gap`, `state_gap`), its embeddings and features by
relative L2 error (`emb_err`, `feat_err`). With `control`, the
reference computed one step lower in precision propagates each sampled
clip itself and is held to the same numbers.
"""

from __future__ import annotations

import torch

from manet_bench import counting, counting_feelvos as cf
from manet_bench.common import now, synchronize
from manet_bench.judge import Tally, label_gaps
from manet_bench.reference import batch as rb
from manet_bench.reference import feelvos as rf
from manet_bench.reference.engine import upsampled_probs
from manet_bench.reference.model import fp32_math
from manet_bench.span_kernels import SpanTrace
from manet_bench.tracing import profiler, span
from manet_bench.traffic import batch_propagation as bp
from manet_bench.weights_feelvos import make_weights

Log = bp.Log


class Traffic(bp.Traffic):
    def __init__(self, cell):
        if cell.config["model"].get("arch") != "feelvos":
            raise ValueError("the FEELVOS traffic takes a configuration "
                             "with arch 'feelvos'")
        super().__init__(cell)
        self.uploaded: list[tuple[int, int]] = []   # (batch, calls)

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from cvpr2020_manet_tpu_torch.engine.propagate_batch import (
            BatchPropagator)
        from cvpr2020_manet_tpu_torch.models.feelvos import FEELVOS
        c, dev = self.cell, self.dev
        t = now()
        self.weights = make_weights(c.config["model"], c.seed, dev,
                                    self.cfg.eval.image_size)
        model = FEELVOS(self.cfg.model, device="meta")
        model.to_empty(device=dev)
        model.load_state_dict(self.weights, strict=True)
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

    # ------------------------------------------------------------ traffic

    def _upload(self, k: int):
        """Batch k's upload, recorded with its encoder calls."""
        ex = super()._upload(k)
        self.uploaded.append((k % len(self.batches), len(ex)))
        return ex

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
                    kept = self._kept_features(ex, b, want)
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
            log.kept[i] = {"probs": state[j]["probs"],
                           "labels": {t: labels[j, t].copy()
                                      for t in self.sample[i]},
                           **kept[j]}
        return nxt

    def _kept_features(self, ex, b: dict, want) -> dict:
        """The program's features and embeddings of the sampled frames of
        the clips at positions `want` of batch `b`, copied from the
        upload's chunks."""
        chunk, t = ex[0][1].shape[0], b["shape"][1]
        out = {}
        for j in want:
            out[j] = {"feat": {}, "emb": {}}
            for f in self.sample[b["clips"][j]]:
                row = j * t + f
                feat, emb = ex[row // chunk]
                out[j]["feat"][f] = feat[row % chunk].clone()
                out[j]["emb"][f] = emb[row % chunk].clone()
        return out

    def traced(self) -> tuple[Log, SpanTrace]:
        """`trace_batches` batches in the pipelined order, untraced for
        their wall, then again under the profiler."""
        t0 = now()
        ex = self._upload(0)
        for k in range(self.trace_batches):
            ex = self._pipelined(k, ex, Log(), None)
        synchronize(self.dev)
        wall = now() - t0
        del ex
        log = Log()
        self.uploaded = []
        with profiler(self.dev) as prof:
            with span("bench.window"):
                ex = self._upload(0)
                for k in range(self.trace_batches):
                    ex = self._pipelined(k, ex, log, None, keep=True)
                synchronize(self.dev)
        del ex
        log.seconds = wall
        return log, SpanTrace.from_profiler(prof, self._work(log, wall))

    def _work(self, log: Log, wall: float) -> dict:
        """What the traced slice asked of the device, at real frames and
        live objects: the encoder's work over every upload in it, the
        head's and the matching kernels' over its dispatched batches, and
        the model's FLOPs of all of them."""
        m = self.cell.config["model"]
        hp, wp = self.cfg.eval.image_size
        s = m["feature_stride"]
        h, w = hp // s, wp // s
        c = m["embedding_dim"]
        enc = cf.encoder_layers(m, hp, wp)
        shared, per_object = cf.head_layers(m, h, w)
        enc_frames = enc_calls = 0
        for k, calls in self.uploaded:
            enc_frames += self.batches[k]["frames"]
            enc_calls += calls
        gm, lm = counting.Work(), counting.Work()
        steps = objects = 0
        flops = enc_frames * cf.flops(enc)
        for b in log.batches:
            for i in b["clips"]:
                n, o = self.clips[i]["n"], self.clips[i]["objects"] + 1
                g = counting.global_matching((n - 1) * h * w, h * w, c, o,
                                             "bf16")
                loc = counting.local_matching(h, w, c, o, m["local_window"])
                gm += g
                for _ in range(n - 1):
                    lm += loc
                steps += n - 1
                objects += (n - 1) * o
                flops += g.ops + (n - 1) * (cf.flops(shared) + loc.ops
                                            + o * cf.flops(per_object))
        return {
            "kernels": {"global_matching": gm, "local_matching": lm},
            "flops": flops, "wall_s": wall,
            "batches": [b["frames"] for b in log.batches],
            "separable_encoder_least_s": cf.least_s(
                [(lay, enc_frames, enc_calls) for lay in enc]),
            "separable_head_least_s": cf.least_s(
                [(lay, steps, steps) for lay in shared]
                + [(lay, objects, steps) for lay in per_object])}

    # ------------------------------------------------------------- check

    def check(self, log: Log, control: bool = False) -> dict:
        """The program's sampled frames, and with `control` those of the
        control in the program's place, each held against the reference
        step by step from the candidate's own probabilities of the frame
        before."""
        m = self.cell.config["model"]
        ref = rf.FeelvosRef(self.weights, m)
        tallies = {"program": Tally()}
        if control:
            tallies["control"] = Tally()
            low = rf.FeelvosRef(self.weights, m, low=True)
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
                labels0 = rb.key_labels(first, ov)
                cands = {"program": (kept["probs"].float(), kept["labels"],
                                     kept["feat"], kept["emb"])}
                if control:
                    p, cfeat, cemb = rf.propagate_clip(
                        low, frames, first, clip["objects"], o, last=max(ts))
                    size = tuple(self.cfg.eval.image_size)
                    cands["control"] = (
                        p, {t: upsampled_probs(p[t], size).argmax(-1)
                            for t in ts},
                        {t: cfeat[t] for t in ts}, {t: cemb[t] for t in ts})
                for name, (probs, labs, feats, embs) in cands.items():
                    tally = tallies[name]
                    for t in ts:
                        rp = rf.step(ref, feat[at[t]], emb[at[t]], emb[0],
                                     labels0, emb[at[t - 1]], probs[t - 1],
                                     ov)
                        lab = torch.as_tensor(labs[t], device=self.dev)
                        up = upsampled_probs(rp, tuple(lab.shape))
                        tally.add("label_gap", label_gaps(up, lab))
                        tally.add("state_gap",
                                  label_gaps(rp, probs[t].argmax(-1)))
                        tally.add_relative(
                            "emb_err", embs[t][..., :emb.shape[-1]].float(),
                            emb[at[t]])
                        tally.add_relative("feat_err", feats[t].float(),
                                           feat[at[t]])
        return {k: t.numbers() for k, t in tallies.items()}
