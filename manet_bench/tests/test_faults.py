"""The check catches a broken timed path: a tiny run on the CPU with the
program broken underneath, seen to come out not correct, once for each
fault a serving cell can have: a call that hands on its state unchanged
(for a round also each of its carried memories alone: the global-map
minima, the interaction memory), and an answer altered where it is
produced. The limits are the cells' own (their workload files)."""

from __future__ import annotations

import numpy as np
import pytest


def _alter(labels: np.ndarray, objects: int) -> np.ndarray:
    """Every label moved to the next object (mod the live labels)."""
    return (labels + 1) % (objects + 1)


STATES = {"state_unchanged": ("prev_masks", "gmap_mem", "int_mem"),
          "gmap_unchanged": ("gmap_mem",), "int_mem_unchanged": ("int_mem",)}


@pytest.mark.parametrize("fault", [*STATES, "answer_altered"])
def test_rounds_fault_is_caught(run_tiny, monkeypatch, fault):
    from cvpr2020_manet_tpu_torch.engine import evaluator as ev
    if fault in STATES:
        real = ev.Evaluator.dispatch_round

        def dispatch(self, state, *a, **k):
            keep = {n: getattr(state, n) for n in STATES[fault]}
            handle = real(self, state, *a, **k)
            for n, v in keep.items():
                setattr(state, n, v)
            return handle

        monkeypatch.setattr(ev.Evaluator, "dispatch_round", dispatch)
    else:
        real = ev.Evaluator.run_round

        def run_round(self, state, js, hw, n):
            return _alter(real(self, state, js, hw, n), n)

        monkeypatch.setattr(ev.Evaluator, "run_round", run_round)
    assert run_tiny("tiny_davis480_rounds")["correct"] is False


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_stream_fault_is_caught(run_tiny, monkeypatch, fault):
    from cvpr2020_manet_tpu_torch.engine import streaming as sm
    if fault == "state_unchanged":
        real = sm.StreamingIVOS.observe_async

        def observe_async(self, image):
            keep = (self.state["prev_emb"], self.state["prev_probs"])
            fut = real(self, image)
            if self.state["rounds"] > 0:
                self.state["prev_emb"], self.state["prev_probs"] = keep
            return fut

        monkeypatch.setattr(sm.StreamingIVOS, "observe_async", observe_async)
    else:
        real = sm.StreamingIVOS._unpack

        def unpack(self, packed, bits):
            return _alter(real(self, packed, bits), 2)

        monkeypatch.setattr(sm.StreamingIVOS, "_unpack", unpack)
    assert run_tiny("tiny_stream1080_int8")["correct"] is False


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_fault_is_caught(run_tiny, monkeypatch, fault):
    from cvpr2020_manet_tpu_torch.engine import train_stage1 as ts
    from cvpr2020_manet_tpu_torch.engine import train_state
    if fault == "state_unchanged":
        def apply_gradients(self):
            self.optimizer.zero_grad(set_to_none=True)
            self.step += 1

        monkeypatch.setattr(train_state.TrainState, "apply_gradients",
                            apply_gradients)
    else:
        real = ts.Trainer.train_step

        def train_step(self, batch, sync=True):
            half = {k: v[:len(v) // 2] for k, v in batch.items()}
            return real(self, half, sync=sync)

        monkeypatch.setattr(ts.Trainer, "train_step", train_step)
    assert run_tiny("tiny_train_stage1_416")["correct"] is False
