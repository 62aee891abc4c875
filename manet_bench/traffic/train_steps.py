"""Stage-1 training steps, fed synchronously as the training CLI feeds
them.

Set-up builds one `Trainer` (model and optimizer state) with the
benchmark's weights, makes a pool of `pool_batches` host batches of
(reference, previous, current) uint8 triplets with their labels from the
seed, and drives the trainer through its first `checked_steps` steps on
the pool's first batches, through the same call the window makes. The
window continues with the same object, one `train_step` after another
over the pool (cycling), each step's metrics read on the host.

The check follows those first steps on the reference from the same
weights and batches, and compares each step's loss, each leaf's first
gradient (read from the optimizer's momentum after one step) and each
leaf's change over the steps, by the worst leaf: the gap between the
program's norm and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf. Leaves whose reference gradient
is under a thousandth of the median leaf's move by round-off alone and
are left out of the leaf numbers.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

from manet_bench import counting, synth
from manet_bench.common import Cell, now, program_config, synchronize
from manet_bench.reference import train as reftrain
from manet_bench.reference.model import fp32_math
from manet_bench.tracing import Trace, profiler, span
from manet_bench.weights import make_weights


@dataclasses.dataclass
class Log:
    steps: list = dataclasses.field(default_factory=list)
    failed: int = 0
    seconds: float = 0.0

    @property
    def requests(self) -> list:
        """The calls the log timed."""
        return self.steps


class Traffic:
    def __init__(self, cell: Cell):
        self.cell = cell
        p = cell.workload["traffic"]
        self.pool_n = p["pool_batches"]
        self.objects = p["objects"]
        self.checked = p["checked_steps"]
        self.trace_steps = p["trace_steps"]
        self.dev = cell.device
        self.cfg = program_config(cell.config)
        self.batch = self.cfg.train.batch_size

    # ------------------------------------------------------------ set-up

    def _batches(self) -> list:
        c = self.cell
        h, w = self.cfg.train.crop_size
        o = self.cfg.model.max_objects + 1
        pool = []
        for j in range(self.pool_n):
            clips = [synth.make_video(c.seed, 1000 * (j + 1) + i, 3, (h, w),
                                      self.objects, self.dev)
                     for i in range(self.batch)]
            valid = np.zeros((self.batch, o), np.float32)
            valid[:, :self.objects + 1] = 1.0
            pool.append({
                "images": np.stack([v for v, _ in clips]),
                "labels": np.stack([lab for _, lab in clips]).astype(np.uint8),
                "obj_valid": valid,
                "frame_valid": np.ones((self.batch, 3), np.float32)})
        return pool

    def setup(self) -> None:
        from cvpr2020_manet_tpu_torch.engine.train_stage1 import Trainer
        c, dev = self.cell, self.dev
        t = now()
        self.weights = make_weights(c.config["model"], c.seed, dev)
        self.trainer = Trainer(self.cfg, device=dev)
        self.trainer.model.load_state_dict(self.weights, strict=True)
        synchronize(dev)
        self.parts = {"weights_s": now() - t}
        t = now()
        self.pool = self._batches()
        self.parts["inputs_s"] = now() - t
        t = now()
        named = dict(self.trainer.model.named_parameters())
        opt = self.trainer.state.optimizer
        self.losses = []
        for k in range(self.checked):
            self.losses.append(self.trainer.train_step(self.pool[k])["loss"])
            if k == 0:
                # no trace where the optimizer took no step
                self.first_trace = {
                    n: opt.state[p].get("momentum_buffer",
                                        torch.zeros_like(p)).clone()
                    for n, p in named.items()}
        self.after = {n: p.detach().clone() for n, p in named.items()}
        self.next = self.checked
        synchronize(dev)
        self.parts["checked_steps_s"] = now() - t

    # ------------------------------------------------------------ traffic

    def _step(self, log: Log) -> float:
        b = self.pool[self.next % self.pool_n]
        t0 = now()
        try:
            with span("bench.step"):
                self.trainer.train_step(b)
        except RuntimeError:
            log.failed += 1
            return now()
        t1 = now()
        self.next += 1
        log.steps.append({"seconds": t1 - t0, "end": t1})
        return t1

    def window(self, seconds: float) -> Log:
        log = Log()
        start = now()
        t = start
        while t < start + seconds:
            t = self._step(log)
        log.seconds = log.steps[-1]["end"] - start
        return log

    def end_to_end(self, log: Log) -> dict:
        return {"train_samples_per_s": len(log.steps) * self.batch
                / log.seconds}

    def traced(self) -> tuple[Log, Trace]:
        """`trace_steps` steps untraced for their wall, then the next as
        many under the profiler."""
        t0 = now()
        for _ in range(self.trace_steps):
            self._step(Log())
        synchronize(self.dev)
        wall = now() - t0
        log = Log()
        with profiler(self.dev) as prof:
            with span("bench.window"):
                for _ in range(self.trace_steps):
                    self._step(log)
                synchronize(self.dev)
        log.seconds = wall
        return log, Trace.from_profiler(prof, self._work(log, wall))

    def _work(self, log: Log, wall: float) -> dict:
        """Per step, the work the inputs need: kernel 4 once a sample (the
        current frame against the reference frame's labelled pixels),
        kernel 5 once a sample (its in-window pairs; the checkpointed
        tail's recompute, which runs it a second time, is a cost of the
        program and is not counted); the model's FLOPs as three times the
        forward's (forward and backward)."""
        m = self.cell.config["model"]
        hc, wc = self.cfg.train.crop_size
        h, w = hc // 4, wc // 4
        c, s = m["embedding_dim"], m["local_downsample"]
        o = self.objects + 1
        fl = counting.model_flops(m, (hc, wc))
        g = counting.global_matching(h * w, h * w, c, o, "bf16")
        loc = counting.local_matching(h // s, w // s, c, o, m["local_window"])
        gm, lm = counting.Work(), counting.Work()
        n = len(log.steps) * self.batch
        for _ in range(n):
            gm += g
            lm += loc
        fwd = (3 * fl["encoder_frame"] + o * (fl["interact_object"]
                                              + fl["head_object"])
               + g.ops + loc.ops)
        return {"kernels": {"global_matching_argmin": gm,
                            "local_matching_argmin": lm},
                "flops": 3.0 * fwd * n, "wall_s": wall,
                "steps": len(log.steps)}

    # ------------------------------------------------------------- check

    def free_program(self) -> None:
        self.trainer = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _device_batches(self, n: int) -> list:
        return [{k: torch.as_tensor(v, device=self.dev)
                 for k, v in b.items()} for b in self.pool[:n]]

    def reference_run(self, **kw):
        t = self.cell.config["train"]
        with fp32_math():
            return reftrain.train(self.weights, self.cell.config["model"], t,
                                  self._device_batches(self.checked), **kw)

    def check(self, log: Log, control: bool = False) -> dict:
        wd = self.cell.config["train"]["weight_decay"]
        ref = self.reference_run()
        program = (self.losses,
                   {k: v - wd * self.weights[k]
                    for k, v in self.first_trace.items()},
                   self.after)
        out = {"program": compare(ref, program, self.weights)}
        if control:
            out["control"] = compare(ref, self.reference_run(low=True),
                                     self.weights)
            out["half_batch"] = compare(
                ref, self.reference_run(keep=self.batch // 2), self.weights)
        return out


def compare(ref, run, start: dict) -> dict:
    """Readings of `run` (losses, first gradients, parameters after the
    steps) against the reference's, from the parameters `start`: each
    step's relative loss gap, and of each leaf's gradient and change the
    worst and the median leaf's gap (`_gaps`), with the worst leaves
    named."""
    r_loss, r_grad, r_after = ref
    loss, grad, after = run
    gnorm = {k: float(v.norm()) for k, v in r_grad.items()}
    med_g = statistics.median(gnorm.values())
    leaves = [k for k, v in gnorm.items() if v >= 1e-3 * med_g]
    grad_gap = _gaps(gnorm, {k: float(grad[k].norm()) for k in leaves},
                     leaves)
    change_gap = _gaps(
        {k: float((r_after[k] - start[k]).norm()) for k in leaves},
        {k: float((after[k] - start[k]).norm()) for k in leaves}, leaves)
    out = {"loss_gap_max": max(abs(a - b) / abs(b)
                               for a, b in zip(loss, r_loss)),
           "leaves_left_out": len(gnorm) - len(leaves)}
    for kind, gaps in (("grad_gap", grad_gap), ("change_gap", change_gap)):
        out[f"{kind}_max"] = max(gaps.values())
        out[f"{kind}_median"] = statistics.median(gaps.values())
        out[f"{kind}_worst"] = ", ".join(
            f"{k} {gaps[k]:.3g}" for k in sorted(gaps, key=gaps.get)[-3:])
    return out


def _gaps(ref_norm: dict, norm: dict, leaves) -> dict:
    """Per leaf |norm - reference norm| over the larger of the leaf's
    reference norm and the median leaf's."""
    med = statistics.median(ref_norm[k] for k in leaves)
    return {k: abs(norm[k] - ref_norm[k]) / max(ref_norm[k], med)
            for k in leaves}
