"""Operations and bytes of FEELVOS's separable encoder and head: the
yardstick of `separable_encoder_roofline` and `separable_head_roofline`,
and the FLOPs that `mfu.serve` reads in the FEELVOS cell.

A layer is one convolution with the norm, activation and residual add
that follow it, and a separable layer (depthwise, norm, [ReLU],
pointwise, norm, [ReLU]) is one layer: a kernel that fuses it need not
write the depthwise output. Its operations are its convolutions' (2
multiply-adds' worth a tap and channel of each output: 2 C k^2 a pixel
for a depthwise conv, 2 Cin Cout for a pointwise one); norms and
activations are not counted. Its bytes: each activation it reads once
and writes once, in bf16 (the configuration's precision), and its
parameters once a call in f32 (as they are stored). The least time of
a set of layers is the sum over the layers of max(operations / 989
TFLOP/s, bytes / 3.35 TB/s) (`counting.py`'s peaks), taken over the
work of all the calls at once (which is no more than the sum over the
calls).

- Encoder (one frame at the padded size): Xception-65, ASPP (each branch
  reads the trunk; the projection reads the concatenation), the
  low-level projection, the decoder (its first layer reads the ASPP
  output at stride 16, the upsample fused in, and the projected low
  level), the embedding (real `embedding_dim`, not its zero padding).
  A unit's third separable layer also reads the residual input of a
  `sum` shortcut; a `conv` shortcut is its own layer, reading the unit's
  input.
- Head (one frame at stride 4): the first layer's feature share once a
  frame (the depthwise on F and its pointwise share: reads F), and per
  object the three map channels through the depthwise and their
  pointwise share, the add, the norm and ReLU (reads three maps, writes
  the layer's output); layers 2-4 per object; the logit (one f32 map per
  object) is fused into layer 4, which then writes it and not its 256
  channels.
"""

from __future__ import annotations

import dataclasses

from manet_bench.counting import HBM_BYTES_PER_S, PEAK
from manet_bench.reference.feelvos import HEAD_KERNEL, HEAD_LAYERS, units

ACT, PARAM = 2, 4            # bytes: a bf16 activation, an f32 parameter


@dataclasses.dataclass
class Layer:
    """One layer: operations and activation bytes of one frame (or one
    object of a frame), and its parameters."""
    name: str
    flops: float
    bytes: float
    params: int = 0


def conv_flops(cin: int, cout: int, k: int, pixels: int,
               groups: int = 1) -> float:
    """2 operations a multiply-add: 2 Cout (Cin / groups) k^2 a pixel."""
    return 2.0 * cout * (cin // groups) * k * k * pixels


def conv(name, cin, cout, k, px_in, px_out, bias=False) -> Layer:
    """A dense conv with its norm and activation."""
    return Layer(name, conv_flops(cin, cout, k, px_out),
                 ACT * (cin * px_in + cout * px_out),
                 cout * cin * k * k + (cout if bias else 2 * cout))


def separable(name, cin, cout, k, px_in, px_out, extra_in=0,
              out_norm=True) -> Layer:
    """A separable layer; `extra_in`: further activation elements read
    (a residual, a second input)."""
    flops = conv_flops(cin, cin, k, px_out, cin) + conv_flops(cin, cout, 1,
                                                              px_out)
    params = cin * k * k + 2 * cin + cin * cout + (2 * cout if out_norm
                                                   else cout)
    return Layer(name, flops,
                 ACT * (cin * px_in + cout * px_out + extra_in), params)


def encoder_layers(m: dict, hp: int, wp: int) -> list[Layer]:
    """The encoder's layers for one frame padded to (hp, wp)."""
    out: list[Layer] = []
    px = [hp * wp // 4]                    # after the root's stride 2
    out.append(conv("root1", 3, 32, 3, hp * wp, px[0]))
    out.append(conv("root2", 32, 64, 3, px[0], px[0]))
    cin, p = 64, px[0]
    low_px = None
    for name, depths, short, stride, _, _ in units(m):
        p_out = p // (stride * stride)
        chans = (cin, *depths)
        for i in range(3):
            pin = p
            pout = p_out if i == 2 else p
            extra = cin * p if (i == 2 and short == "sum") else 0
            out.append(separable(f"{name}.sep{i}", chans[i], chans[i + 1], 3,
                                 pin, pout, extra))
        if short == "conv":
            out.append(Layer(f"{name}.shortcut",
                             conv_flops(cin, depths[-1], 1, p_out),
                             ACT * cin * p, depths[-1] * cin + 2 * depths[-1]))
        if name == "entry2":
            low_px = p
        cin, p = depths[-1], p_out
    a, ll, cd = (m["aspp_channels"], m["low_level_channels"],
                 m["decoder_channels"])
    out.append(conv("aspp.conv0", cin, a, 1, p, p))
    for i in range(3):
        out.append(separable(f"aspp.sep{i}", cin, a, 3, p, p))
    out.append(Layer("aspp.pool", conv_flops(cin, a, 1, 1),
                     ACT * (cin * p + a), a * cin + 2 * a))
    out.append(conv("aspp.project", 5 * a, a, 1, p, p))
    out.append(conv("low_level_proj", 256, ll, 1, low_px, low_px))
    out.append(separable("decoder0", a + ll, cd, 3, 0, low_px,
                         extra_in=a * p + ll * low_px))
    out.append(separable("decoder1", cd, cd, 3, low_px, low_px))
    out.append(separable("embedding", cd, m["embedding_dim"], 3, low_px,
                         low_px, out_norm=False))
    return out


def head_layers(m: dict, h: int, w: int) -> tuple[list[Layer], list[Layer]]:
    """(the layers once a frame, the layers once an object of a frame)
    of the head at stride 4, (h, w) pixels."""
    px, cf, c, k = h * w, m["decoder_channels"], m["head_channels"], \
        HEAD_KERNEL
    shared = [Layer("layer0.feature",
                    conv_flops(cf, cf, k, px, cf) + conv_flops(cf, c, 1, px),
                    ACT * cf * px, cf * k * k + 2 * cf + cf * c)]
    per_object = [Layer("layer0.maps",
                        conv_flops(3, 3, k, px, 3) + conv_flops(3, c, 1, px),
                        ACT * (3 + c) * px, 3 * k * k + 6 + 3 * c + 2 * c)]
    for i in range(1, HEAD_LAYERS):
        last = i == HEAD_LAYERS - 1
        lay = separable(f"layer{i}", c, c, k, px, px)
        if last:     # the logit fused in: one f32 map out, not c channels
            lay = Layer(f"layer{i}+logit", lay.flops + conv_flops(c, 1, 1, px),
                        ACT * c * px + 4 * px, lay.params + c + 1)
        per_object.append(lay)
    return shared, per_object


def least_s(counted) -> float:
    """Sum over layers of max(operations / bf16 peak, bytes / bandwidth):
    `counted` is [(layer, units, calls)], `units` frames or objects of
    frames, `calls` how often its parameters are read."""
    total = 0.0
    for lay, n, calls in counted:
        total += max(n * lay.flops / PEAK["bf16"],
                     (n * lay.bytes + calls * lay.params * PARAM)
                     / HBM_BYTES_PER_S)
    return total


def flops(layers) -> float:
    return sum(lay.flops for lay in layers)
