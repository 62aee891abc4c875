"""The DAVIS interactive protocol: the evaluation loop, the robot and
J&F scoring around 480p rounds.

Set-up writes the fake DAVIS-2017 val tree of the program's
`data/fake_davis.py` (its sequences, 480x854 JPEG frames, indexed PNG
masks, 3 scribble sets; a thread a sequence) into a temporary folder and
opens it with the program's `DavisEvalDataset`; then it runs two rounds
of one item in each frame bucket the tree has. The seed draws the
weights; the tree is the same in every run.

The window drives `Evaluator.run_session` with an `InteractiveSession`
(the robot, `rounds` rounds an item) set-major: set 1 of every sequence,
then set 2, and so on (a session a set, the other items skipped through
`skip_items`). A submission is
timed from `get_scribbles` returning to `submit_masks` returning: a
sequence's first round also decodes its JPEG frames and runs the
encoder, every round runs the model, the scoring and the robot.

The check takes a sample of submissions drawn from the seed (a first and
a later round of an item that a traced run drives, a later round on the
longest sequence and one on the sequence with the most objects, and more
later rounds) and holds each against the reference's round from the
same inputs, as the rounds cell does: the frames as the dataset decodes
them, the round's scribbles rasterized here from their JSON, and the
state the program handed on from the round before.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch

from manet_bench import synth
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
    submissions: list = dataclasses.field(default_factory=list)
    kept: dict = dataclasses.field(default_factory=dict)
    embeddings: dict = dataclasses.field(default_factory=dict)
    failed: int = 0
    seconds: float = 0.0

    @property
    def requests(self) -> list:
        """The calls the log timed."""
        return self.submissions


def _line(x0: int, y0: int, x1: int, y1: int):
    """The pixels of a line from (x0, y0) to (x1, y1), ends included: the
    integer Bresenham walk."""
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx, sy = (1 if x0 < x1 else -1), (1 if y0 < y1 else -1)
    err = dx + dy
    while True:
        yield x0, y0
        if x0 == x1 and y0 == y1:
            return
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def raster(lines, size, pad_to: int) -> np.ndarray:
    """The label raster (Hp, Wp) int64 of one frame's DAVIS scribble lines
    (normalized [x, y] points joined by lines, later lines drawn over
    earlier ones), -1 where nothing is drawn, padded at the bottom and
    right to `pad_to`."""
    h, w = size
    out = np.full((h + (-h) % pad_to, w + (-w) % pad_to), -1, np.int64)
    for line in lines:
        p = np.asarray(line["path"], np.float64).reshape(-1, 2)
        if len(p) == 0:
            continue
        xs = np.clip(np.round(p[:, 0] * (w - 1)), 0, w - 1).astype(int)
        ys = np.clip(np.round(p[:, 1] * (h - 1)), 0, h - 1).astype(int)
        out[ys[0], xs[0]] = line["object_id"]
        for i in range(len(p) - 1):
            for x, y in _line(xs[i], ys[i], xs[i + 1], ys[i + 1]):
                out[y, x] = line["object_id"]
    return out


def _classes():
    """The program's session and evaluator, each with the harness's
    records around the program's own methods."""
    from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
    from cvpr2020_manet_tpu_torch.interactive.session import (
        InteractiveSession)

    class Session(InteractiveSession):
        """Times each submission (`bench.submit`), stops at a deadline,
        and tells the evaluator which rounds to record."""

        def __init__(self, ds, *, first_item: int, log: Log, ev, sample,
                     deadline=None, **kw):
            super().__init__(ds, **kw)
            self.first_item, self.log, self.ev = first_item, log, ev
            self.sample, self.deadline = sample, deadline
            self.seqs = ds.sequences()
            self.key, self.round = None, 0

        def next(self) -> bool:
            if self.deadline is not None and now() >= self.deadline:
                return False
            return super().next()

        def get_scribbles(self, only_last: bool = False):
            out = super().get_scribbles(only_last)
            if self.current != self.key:
                self.key, self.round = self.current, 0
            k = self.first_item + self.seqs.index(self.current[0])
            self.ev.record = {} if (k, self.round) in self.sample else None
            self.item = k
            self.span = torch.profiler.record_function("bench.submit")
            self.span.__enter__()
            self.t0 = now()
            return out

        def submit_masks(self, masks) -> None:
            try:
                super().submit_masks(masks)
            finally:
                self.span.__exit__(None, None, None)
            t1 = now()
            k, r = self.item, self.round
            self.log.submissions.append({
                "seconds": t1 - self.t0, "end": t1, "item": k, "round": r,
                "frames": int(np.asarray(masks).shape[0])})
            rec = self.ev.record
            if rec is not None:
                self.log.kept[(k, r)] = rec
                self.log.embeddings.setdefault(k, rec.pop("emb"))
            self.ev.record = None
            self.round += 1

    class Recording(Evaluator):
        """Keeps, for the rounds the session names, the state before and
        after, the scribbles and the embeddings."""
        record = None

        def run_round(self, state, scribbles_json, image_hw, num_objects):
            rec = self.record
            if rec is not None:
                rec.update(before=(state.prev_masks, state.gmap_mem,
                                   state.int_mem),
                           js=scribbles_json, emb=state.emb)
            masks = super().run_round(state, scribbles_json, image_hw,
                                      num_objects)
            if rec is not None:
                rec.update(after=(state.prev_masks, state.gmap_mem,
                                  state.int_mem), masks=masks)
            return masks

    return Session, Recording


class Traffic:
    def __init__(self, cell: Cell):
        self.cell = cell
        p = cell.workload["traffic"]
        self.rounds = p["rounds"]
        self.sets = p["scribble_sets"]
        self.size = tuple(p["image_size"])
        self.tree_seed = p["tree_seed"]
        self.trace_items = p["trace_items"]
        self.seq_spec = p.get("sequences")
        self.spec = cell.workload["check"]
        self.dev = cell.device
        self.cfg = program_config(cell.config)
        self.backend = cell.config.get("matching_backend", "auto")
        self.tree = None

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from cvpr2020_manet_tpu_torch.data import fake_davis
        from cvpr2020_manet_tpu_torch.data.davis import DavisEvalDataset
        c, dev = self.cell, self.dev
        t = now()
        seqs = [tuple(s) for s in (self.seq_spec or fake_davis.SEQUENCES)]
        self.tree = tempfile.mkdtemp(prefix="fake_davis_")
        pool = concurrent.futures.ThreadPoolExecutor(len(seqs))
        writes = [pool.submit(fake_davis.write_sequence, self.tree, name, n,
                              objects, self.tree_seed + i, *self.size)
                  for i, (name, n, objects) in enumerate(seqs)]
        self.weights = make_weights(c.config["model"], c.seed, dev)
        model = program_model(self.cfg, c.config, self.weights, dev)
        self.Session, evaluator = _classes()
        self.ev = evaluator(self.cfg, model, device=dev)
        synchronize(dev)
        self.parts = {"weights_s": now() - t}
        for w in writes:
            w.result()
        pool.shutdown()
        sets_dir = os.path.join(self.tree, "ImageSets", "2017")
        os.makedirs(sets_dir)
        with open(os.path.join(sets_dir, "val.txt"), "w") as f:
            f.write("".join(name + "\n" for name, _, _ in seqs))
        self.ds = DavisEvalDataset(self.tree, scribble_sets=self.sets)
        self.seqs = self.ds.sequences()
        self.frames = {name: n for name, n, _ in seqs}
        self.objects = {name: n for name, _, n in seqs}
        self.sample = self._draw_sample()
        self.parts["tree_s"] = now() - t - self.parts["weights_s"]
        t = now()
        # two rounds of an item in each frame bucket
        seen, warm = set(), []
        for i, name in enumerate(self.seqs):
            key = (self.ev.frame_bucket(self.frames[name]),
                   self.ev.object_bucket(self.objects[name]))
            if key not in seen:
                seen.add(key)
                warm.append(i)
        self._session(0, warm, Log(), rounds=2)
        synchronize(dev)
        self.parts["warm_s"] = now() - t

    def _draw_sample(self) -> set:
        """(item, round) pairs of the first `sample_items` items (set-major
        order) to check: a first and a later round of an item that a
        traced run drives, a later round on the longest sequence and one
        on the sequence with the most objects, and `later_rounds` more
        later rounds."""
        r = synth.rng(self.cell.seed, 8)
        n = min(len(self.seqs) * self.sets, self.spec["sample_items"])
        seq = [self.seqs[k % len(self.seqs)] for k in range(n)]
        traced = min(n, self.trace_items)
        longest = max(range(n), key=lambda k: self.frames[seq[k]])
        most = max(range(n), key=lambda k: self.objects[seq[k]])
        out = {(int(r.integers(traced)), 0)}
        later = [(k, j) for k in range(n) for j in range(1, self.rounds)]
        if later:
            for k in (int(r.integers(traced)), longest, most):
                out.add((k, int(r.integers(1, self.rounds))))
            rest = [p for p in later if p not in out]
            pick = r.choice(len(rest), size=min(len(rest),
                                                self.spec["later_rounds"]),
                            replace=False)
            out.update(rest[j] for j in pick)
        return out

    # ------------------------------------------------------------ traffic

    def _session(self, set_idx: int, positions, log: Log, deadline=None,
                 rounds=None, first_item: int = 0) -> None:
        """The protocol over the items of set `set_idx` at `positions` of
        the sequence list, through the program's `run_session`."""
        keep = {(self.seqs[i], set_idx) for i in positions}
        skip = {(s, j) for s in self.seqs for j in range(self.sets)} - keep
        sess = self.Session(self.ds, first_item=first_item, log=log,
                            ev=self.ev, sample=self.sample,
                            deadline=deadline,
                            max_interactions=rounds or self.rounds,
                            skip_items=skip)
        try:
            self.ev.run_session(sess)
        except RuntimeError:
            log.failed += 1

    def window(self, seconds: float) -> Log:
        log = Log()
        start = now()
        deadline = start + seconds
        n, k = len(self.seqs), 0
        while now() < deadline:
            self._session((k // n) % self.sets, range(n), log, deadline,
                          first_item=k)
            k += n
        log.seconds = log.submissions[-1]["end"] - start
        return log

    def end_to_end(self, log: Log) -> dict:
        lat = [s["seconds"] for s in log.submissions]
        return {"round_p90_ms": percentile(lat, 90) * 1e3,
                "frames_per_s": sum(s["frames"] for s in log.submissions)
                / log.seconds}

    def traced(self) -> tuple[Log, Trace]:
        """The first `trace_items` items, untraced for their wall and then
        again under the profiler."""
        items = range(self.trace_items)
        t0 = now()
        self._session(0, items, Log())
        synchronize(self.dev)
        wall = now() - t0
        log = Log()
        with profiler(self.dev) as prof:
            with span("bench.window"):
                self._session(0, items, log)
                synchronize(self.dev)
        log.seconds = wall
        return log, Trace.from_profiler(prof, {
            "kernels": {}, "wall_s": wall,
            "submissions": len(log.submissions)})

    # ------------------------------------------------------------- check

    def free_program(self) -> None:
        self.ev = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, log: Log, control: bool = False) -> dict:
        """The readings of the program's sampled submissions, and with
        `control` those of the control (the reference one step lower in
        precision, from the same state) in the program's place, held
        against the reference stage by stage (`round_steps`), as the
        rounds cell holds its rounds."""
        m = self.cell.config["model"]
        backend = "int8" if self.backend == "int8" else "bf16"
        ref = Ref(self.weights, m, matching=backend)
        low = Ref(self.weights, m, matching=backend, low=True)
        tallies = {"program": Tally()}
        if control:
            tallies["control"] = Tally()
        pad_to, stride = self.cfg.eval.pad_to, m["feature_stride"]
        encoded: dict = {}
        try:
            with fp32_math(), torch.no_grad():
                for (k, r), kept in sorted(log.kept.items()):
                    self._check_one(k, r, kept, log, ref, low, tallies,
                                    encoded, pad_to, stride)
        finally:
            self.close()
        return {k: t.numbers() for k, t in tallies.items()}

    def _check_one(self, k, r, kept, log, ref, low, tallies, encoded,
                   pad_to, stride) -> None:
        seq = self.seqs[k % len(self.seqs)]
        frames = self.ds.images_uint8(seq)
        nf, n = frames.shape[0], self.objects[seq]
        hw = frames.shape[1:3]
        js = kept["js"]
        annotated = [f for f, lines in enumerate(js["scribbles"]) if lines]
        annot = annotated[0] if annotated else 0
        rast = torch.from_numpy(raster(js["scribbles"][annot], hw,
                                       pad_to)).to(self.dev)
        size = tuple(rast.shape)
        if encoded.get("seq") != seq:
            encoded.clear()
            encoded.update(seq=seq, ref=encode(ref, frames, pad_to, self.dev))
            if "control" in tallies:
                encoded["control"] = encode(low, frames, pad_to, self.dev)
        feat, emb = encoded["ref"]
        probs0, gmap0, mem0 = kept["before"]
        before = (RoundState.initial(nf, *feat.shape[1:3], probs0.shape[-1],
                                     self.dev)
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
                probs, gmap, mem = run_round(low, cf, cand_emb, before, rast,
                                             annot, n, nf, stride)
                labels = upsampled_probs(probs, size)[
                    :, :hw[0], :hw[1]].argmax(-1)
            ref_p, ref_g, ref_m = round_steps(ref, feat, emb, before, probs,
                                              rast, annot, n, nf, stride)
            for f in range(nf):
                up = upsampled_probs(ref_p[f], size)[:hw[0], :hw[1]]
                tally.add("label_gap", label_gaps(up, labels[f]))
            tally.add("state_gap", label_gaps(ref_p, probs.argmax(-1)))
            moved = (gmap < gmap0[:nf]) | (ref_g < gmap0[:nf])
            if moved.any():
                tally.add("gmap_err", (gmap - ref_g)[moved].abs())
            tally.add_relative("int_mem_err", mem, ref_m)
            tally.add_relative("emb_err", cand_emb.float(), emb)

    def close(self) -> None:
        """Remove the tree."""
        if self.tree is not None:
            shutil.rmtree(self.tree, ignore_errors=True)
            self.tree = None
