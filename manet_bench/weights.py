"""Seeded weights, made on the device in one draw.

The parameter set is the reference's (`reference.model.param_shapes`);
the program loads the same tensors by name, strictly, so a program whose
parameters differ from the architecture fails loudly. Scales follow a
fan-in rule so that activations stay near unit size through the 101
layers: conv kernels normal with variance 1 / fan-in, cut at two sigma;
norm scales 1 + 0.1 z and every bias 0.1 z.
"""

from __future__ import annotations

import math

import torch

from manet_bench.reference.model import param_shapes
from manet_bench.synth import generator


def make_weights(model_cfg: dict, seed: int, device) -> dict:
    """name -> float32 tensor on `device`, drawn from `seed`."""
    shapes = param_shapes(model_cfg)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, device, 0),
                       device=device)
    out, pos = {}, 0
    with torch.no_grad():
        for name in sorted(shapes):
            shape = shapes[name]
            n = math.prod(shape)
            z = flat[pos:pos + n].view(shape)
            pos += n
            if len(shape) == 4:
                fan_in = shape[1] * shape[2] * shape[3]
                z = z.clamp_(-2.0, 2.0).mul_(1.0 / math.sqrt(fan_in))
            elif name.endswith(".weight"):
                z = z.mul_(0.1).add_(1.0)
            else:
                z = z.mul_(0.1)
            out[name] = z
    return out
