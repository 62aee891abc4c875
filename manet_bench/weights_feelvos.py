"""Seeded weights of the FEELVOS configuration, made on the device, with
its frozen norms calibrated.

The parameter set is the reference's (`reference.feelvos.param_shapes`);
the program loads the same tensors by name, strictly. Convs are drawn as
in `weights.py` (normal with variance 1 / fan-in, a depthwise kernel's
fan-in being its k x k taps, cut at two sigma), the head's logit bias
and the embedding's bias 0.1 z. Each frozen norm draws a target scale
g = 1 + 0.1 z and shift b = SHIFT + 0.1 z, and `reference.feelvos.
calibrate` folds the statistics of seeded frames (two clips of two
frames) into them, in f32 with TF32 off, layer by layer, so that the
norm's output has mean b and standard deviation g a channel: 65 layers
stay at unit scale. With SHIFT 1 each norm's output sits one deviation
above zero and the ReLU after it passes about 84% of it: the net
contracts, so bf16 rounding moves the embedding 0.058-0.065 (relative
L2) from the f32 reference's against the fp8 control's 0.38-0.41, while
a dropped ReLU moves the answers several times past the cell's limits
(the fault cases of tests/test_torch_feelvos_cell.py). With centred
outputs (SHIFT 0) the net is chaotic: bf16 rounding alone moves the
embedding 0.86, the f32 reference run in bf16 as far as the program.
With SHIFT 2 the ReLUs pass 98%, the net is nearly affine, and a dropped
ReLU stays inside the limits (480 x 864, one H100). Program and
reference load the calibrated values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from manet_bench import synth
from manet_bench.reference.feelvos import (
    FeelvosRef, calibrate, norm_names, param_shapes)
from manet_bench.reference.model import fp32_math

CALIBRATION_OBJECTS = 2
SHIFT = 1.0          # the norms' output mean, in deviations
CALIBRATION_KEY = 900


def draw(model_cfg: dict, seed: int, device) -> dict:
    """name -> float32 tensor on `device`, drawn from `seed`, the norms
    not yet calibrated."""
    shapes = param_shapes(model_cfg)
    norm_shifts = {f"{n}.bias" for n in norm_names(model_cfg)}
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=synth.generator(seed, device, 0),
                       device=device)
    out, pos = {}, 0
    for name in sorted(shapes):
        shape = shapes[name]
        n = math.prod(shape)
        z = flat[pos:pos + n].view(shape)
        pos += n
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            z = z.clamp(-2.0, 2.0) * (1.0 / math.sqrt(fan_in))
        elif name.endswith(".weight"):
            z = z * 0.1 + 1.0
        elif name in norm_shifts:
            z = z * 0.1 + SHIFT
        else:
            z = z * 0.1
        out[name] = z
    return out


def make_weights(model_cfg: dict, seed: int, device, image_hw) -> dict:
    """The drawn weights with every frozen norm calibrated on seeded
    frames at `image_hw` (the configuration's padded size): two clips of
    two frames, CALIBRATION_OBJECTS objects each, the encoder over all
    four, the head on the first clip."""
    sd = draw(model_cfg, seed, device)
    videos = [synth.make_video(seed, CALIBRATION_KEY + i, 2, tuple(image_hw),
                               CALIBRATION_OBJECTS, device) for i in range(2)]
    s = model_cfg["feature_stride"]
    first = torch.from_numpy(videos[0][1][0, ::s, ::s].astype("int64")) \
        .to(device)
    rgb = torch.from_numpy(np.concatenate([v[0] for v in videos])).to(device)
    with fp32_math(), torch.no_grad():
        calibrate(FeelvosRef(sd, model_cfg), rgb, first, CALIBRATION_OBJECTS)
    return sd

