"""How an answer is held against the reference.

An answer is a label map. With random weights the largest probability
of a pixel often wins by a hair, so a label is judged by its gap: how far
the reference's probability of the label given lies below the
reference's best at that pixel (0 where they pick the same). A state of
probabilities that the program hands to its next call is judged the same
way, through its argmax.

`Tally` gathers the gaps of every compared pixel into the numbers that
the workload file sets limits for.
"""

from __future__ import annotations

import torch


def label_gaps(ref_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """ref_probs (..., O), labels (...) integer -> gaps (...)."""
    best = ref_probs.amax(-1)
    given = ref_probs.gather(-1, labels.long().clamp(0, ref_probs.shape[-1] - 1)
                             [..., None])[..., 0]
    out = best - given
    # a label outside the object range is as wrong as can be
    return torch.where((labels < 0) | (labels >= ref_probs.shape[-1]),
                       torch.ones_like(out), out)


class Tally:
    """Per-pixel gaps by kind, the answers' ("label_gap") and the state's
    handed on ("state_gap"), each giving its mean and maximum; and
    relative errors of whole tensors ("emb_err"), giving the maximum."""

    def __init__(self):
        self.sums: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.maxes: dict[str, float] = {}

    def add(self, kind: str, gaps: torch.Tensor) -> None:
        g = gaps.double()
        self.sums[kind] = self.sums.get(kind, 0.0) + float(g.sum())
        self.counts[kind] = self.counts.get(kind, 0) + g.numel()
        self.maxes[kind] = max(self.maxes.get(kind, 0.0), float(g.max()))

    def add_relative(self, kind: str, x: torch.Tensor,
                     ref: torch.Tensor) -> None:
        err = float((x.double() - ref.double()).norm()
                    / ref.double().norm().clamp(min=1e-30))
        self.maxes[kind] = max(self.maxes.get(kind, 0.0), err)

    def numbers(self) -> dict[str, float]:
        out = {}
        for kind, m in self.maxes.items():
            out[f"{kind}_max"] = m
            if kind in self.sums:
                out[f"{kind}_mean"] = self.sums[kind] / self.counts[kind]
        return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number that has a limit at or under it -> (correct, {name:
    {"value", "limit"}}); a limit whose number is missing fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, checks
