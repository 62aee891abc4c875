"""Operations, bytes and peaks: the yardstick of the roofline and MFU
metrics.

Operations are the work that the inputs need, counted from the cell's
shapes, whatever kernel does it: the real embedding width (not the
kernel's padded one), the real frames and query rows (not the frame
bucket's padding), the labelled key rows, the in-window pairs of local
matching, the live objects. Bytes count each input read once and each
output written once.

One rule for peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): bf16
work against 989 TFLOP/s, int8 against 1,979 TOP/s, f32 products
against the TF32 tensor peak of 495 TFLOP/s (no f32 kernel on this chip
runs faster), bytes against 3.35 TB/s. A roofline share is the least
time (the larger of operations over peak and bytes over bandwidth) over
the measured kernel time; MFU is the model's FLOPs over the window's
seconds times the bf16 peak.
"""

from __future__ import annotations

import dataclasses

PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class Work:
    """Operations and bytes of some calls, and the peak they run at."""
    ops: float = 0.0
    bytes: float = 0.0
    peak: str = "bf16"

    def __iadd__(self, other: "Work") -> "Work":
        self.ops += other.ops
        self.bytes += other.bytes
        self.peak = other.peak
        return self

    def least_s(self) -> float:
        return max(self.ops / PEAK[self.peak], self.bytes / HBM_BYTES_PER_S)


def global_matching(nq: int, nk: int, c: int, objects: int,
                    backend: str) -> Work:
    """Query rows (nq, c) against labelled key rows (nk, c): the squared
    distance of every pair (2 c operations), the minimum per object.
    bf16: both sides bf16; int8: a bf16 query (quantized inside) against
    int8 keys with one f32 norm a row. Output f32 (nq, objects)."""
    ops = 2.0 * c * nq * nk
    if backend == "int8":
        return Work(ops, nq * c * 2 + nk * (c + 4) + nq * objects * 4, "int8")
    return Work(ops, (nq + nk) * c * 2 + nq * objects * 4, "bf16")


def window_pairs(n: int, window: int) -> int:
    """Sum over positions 0..n-1 of the offsets within `window` that stay
    inside [0, n)."""
    return sum(min(i, window) + min(n - 1 - i, window) + 1 for i in range(n))


def local_matching(h: int, w: int, c: int, objects: int, window: int) -> Work:
    """Each pixel of an (h, w, c) f32 query against the previous frame's
    pixels within `window` in both axes (only offsets inside the frame),
    the minimum per object of the previous labels. Inputs: two f32 maps
    and one label a pixel; output f32 (h, w, objects)."""
    pairs = window_pairs(h, window) * window_pairs(w, window)
    return Work(2.0 * c * pairs,
                h * w * (2 * c * 4 + 4 + objects * 4), "tf32")


def share(work: Work, kernel_ns: int):
    """The roofline share in %, or None where no kernel time was read."""
    if kernel_ns <= 0 or work.ops <= 0:
        return None
    return 100.0 * work.least_s() / (kernel_ns / 1e9)


# ------------------------------------------------------------- model FLOPs


def model_flops(model_cfg: dict, image_hw) -> dict:
    """FLOPs of the reference's pieces, counted on the meta device by
    `torch.utils.flop_counter` (convolutions and products): the encoder
    for one frame padded to `image_hw`, and per object the interaction
    head, the memory gate and the propagation head at stride 4."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from manet_bench.reference.model import Ref, param_shapes

    meta = torch.device("meta")
    sd = {k: torch.empty(s, device=meta)
          for k, s in param_shapes(model_cfg).items()}
    ref = Ref(sd, model_cfg)
    hp, wp = image_hw
    h, w = hp // 4, wp // 4
    cd, cma = model_cfg["decoder_channels"], model_cfg["ma_channels"]

    def count(fn):
        with FlopCounterMode(display=False) as fc:
            fn()
        return float(fc.get_total_flops())

    maps = torch.empty((h, w, 1), device=meta)
    feat = torch.empty((h, w, cd), device=meta)
    mem = torch.empty((1, cma, h, w), device=meta)
    frame = (feat[None], maps[None], maps[None], maps[None], mem)
    return {
        "encoder_frame": count(lambda: ref.encoder(
            torch.empty((1, 3, hp, wp), device=meta))),
        "interact_object": count(lambda: ref.interact(feat, maps, maps, maps)),
        "gate_object": count(lambda: ref.aggregate(mem, mem, False)),
        "head_object": count(lambda: ref.head(*frame)),
    }
