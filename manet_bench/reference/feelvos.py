"""Plain float32 FEELVOS: the reference of the `feelvos_x65_davis480_batch`
configuration.

FEELVOS (Voigtlaender, Chai, Schroff, Adam, Leibe and Chen, CVPR 2019,
arXiv:1902.09513) on DeepLabv3+ with Xception-65 (Chen et al.,
arXiv:1802.02611, §3.3), written out from those papers and DeepLab's
`xception_65`, `xception_module` and `split_separable_conv2d`:

- a separable layer S(c, k, rate, inner_relu) is a k x k depthwise conv
  at `rate`, BatchNorm, a 1x1 pointwise conv to c, BatchNorm; with
  `inner_relu` false (the entry and middle flows) a ReLU comes first, with
  it true (the exit flow's last block, ASPP, decoder, head) a ReLU follows
  each BatchNorm;
- Xception-65: a 3x3/2 conv to 32 and a 3x3 conv to 64 (BatchNorm, ReLU),
  then residual units of three S layers, the third carrying the stride:
  entry blocks [128]*3, [256]*3, [728]*3 at stride 2 with a 1x1 conv
  shortcut; 16 middle units [728]*3 with an identity shortcut; exit
  block 1 [728, 1024, 1024] with a 1x1 conv shortcut; exit block 2
  [1536, 1536, 2048], ReLU inside, no shortcut. At output stride 16 the
  strides stop as DeepLab's `stack_blocks_dense` stops them: exit block
  1 at stride 1 and rate 1, exit block 2 at rate 2;
- the low-level feature: entry block 2's second pointwise output after
  its BatchNorm (256 channels at stride 4);
- ASPP: a 1x1, three S(256, 3, 6 / 12 / 18, True), image pooling (a 1x1,
  BatchNorm, ReLU, broadcast), concatenated and projected by a 1x1,
  BatchNorm, ReLU;
- the decoder: the low-level feature through a 1x1 to 48, BatchNorm,
  ReLU; the ASPP output upsampled bilinearly to stride 4; concatenated
  [ASPP, low level] and through two S(256, 3, 1, True): the feature F;
- the embedding (FEELVOS §3): on F a depthwise 3x3, BatchNorm, ReLU,
  then a 1x1 to 100 with a bias;
- matching, d = 1 - 2 / (1 + exp(||e_p - e_q||^2)): the global map G_o,
  the least d to frame 0's pixels of object o; the local map L_o, the
  least d to frame t-1's pixels of o within a (2k+1)^2 window at k = 15,
  1 where there are none (`reference.model.Ref`'s plain matching);
- the dynamic segmentation head, per object with the background as an
  object and shared weights: [F, G_o, L_o, P_{t-1,o}] (P the previous
  frame's softmax) through four S(256, 7, 1, True) and a 1x1 to one logit
  with a bias; absent objects masked, a softmax over the objects.

BatchNorm is frozen: a scale and a shift a channel
(`param_shapes`' `.weight` and `.bias` of each norm), which
`calibrate` sets from a seeded batch.

Departures from the papers, none of which changes the computation's
kind: the ASPP output is upsampled with half-pixel centres (DeepLab's
TensorFlow resize aligns corners), the port's convention in every
configuration; dropout is left out (inference); random weights from the
seed with calibrated norms stand for the trained ones; padding is
symmetric, `rate (k - 1) / 2` a side (DeepLab's explicit padding, the
same at these strides).

Everything runs in float32 with TF32 off (the caller enters
`model.fp32_math`), one frame at a time, without kernels, batching or a
cache; it imports nothing of the program. `FeelvosRef(low=True)` is the
control: every conv's activations and weights through per-tensor scaled
fp8 e4m3, global matching on fp8 rows, local matching in TF32, as
`reference.model.Ref`'s control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from manet_bench.reference.batch import (
    encode_frames, first_probs, key_labels, normalized, object_valid)
from manet_bench.reference.model import NEG_INF, Ref, _up

BN_EPS = 1e-5
HEAD_LAYERS, HEAD_KERNEL = 4, 7

# (name, depths, shortcut, stride, inner_relu); the middle flow repeats
ENTRY = [("entry1", (128, 128, 128), "conv", 2, False),
         ("entry2", (256, 256, 256), "conv", 2, False),
         ("entry3", (728, 728, 728), "conv", 2, False)]
MIDDLE = ((728, 728, 728), "sum", 1, False)
MIDDLE_UNITS = 16
EXIT = [("exit1", (728, 1024, 1024), "conv", 2, False),
        ("exit2", (1536, 1536, 2048), "none", 1, True)]
BB = "encoder.backbone"


def units(m: dict) -> list:
    """(name, depths, shortcut, stride, rate, inner_relu) of every
    Xception unit at the config's output stride."""
    plan = [*ENTRY, *((f"middle{i}", *MIDDLE)
                      for i in range(MIDDLE_UNITS)), *EXIT]
    target = m["output_stride"] // 2       # after the root's stride 2
    current, rate, out = 1, 1, []
    for name, depths, short, stride, inner in plan:
        if current == target:
            out.append((name, depths, short, 1, rate, inner))
            rate *= stride
        else:
            out.append((name, depths, short, stride, 1, inner))
            current *= stride
    return out


def param_shapes(m: dict) -> dict[str, tuple]:
    """Every parameter under the model config `m`, by name (the
    program's names)."""
    shapes: dict[str, tuple] = {}

    def conv(name, cin, cout, k, bias=False, groups=1):
        shapes[f"{name}.weight"] = (cout, cin // groups, k, k)
        if bias:
            shapes[f"{name}.bias"] = (cout,)

    def norm(name, c):
        shapes[f"{name}.weight"] = (c,)
        shapes[f"{name}.bias"] = (c,)

    def sep(name, cin, cout, k, out_norm=True):
        conv(f"{name}.dw", cin, cin, k, groups=cin)
        norm(f"{name}.dw_norm", cin)
        conv(f"{name}.pw", cin, cout, 1, bias=not out_norm)
        if out_norm:
            norm(f"{name}.pw_norm", cout)

    conv(f"{BB}.root_conv1", 3, 32, 3)
    norm(f"{BB}.root_norm1", 32)
    conv(f"{BB}.root_conv2", 32, 64, 3)
    norm(f"{BB}.root_norm2", 64)
    cin = 64
    for name, depths, short, _, _, _ in units(m):
        p = f"{BB}.units.{name}"
        chans = (cin, *depths)
        for i in range(3):
            sep(f"{p}.sep.{i}", chans[i], chans[i + 1], 3)
        if short == "conv":
            conv(f"{p}.shortcut", cin, depths[-1], 1)
            norm(f"{p}.shortcut_norm", depths[-1])
        cin = depths[-1]
    a, ll = m["aspp_channels"], m["low_level_channels"]
    conv("encoder.aspp.conv0", cin, a, 1)
    norm("encoder.aspp.norm0", a)
    for i in range(3):
        sep(f"encoder.aspp.sep.{i}", cin, a, 3)
    conv("encoder.aspp.pool_conv", cin, a, 1)
    norm("encoder.aspp.pool_norm", a)
    conv("encoder.aspp.project", 5 * a, a, 1)
    norm("encoder.aspp.project_norm", a)
    conv("encoder.low_level_proj", 256, ll, 1)
    norm("encoder.low_level_norm", ll)
    cd = m["decoder_channels"]
    sep("encoder.decoder.0", a + ll, cd, 3)
    sep("encoder.decoder.1", cd, cd, 3)
    sep("encoder.embedding", cd, m["embedding_dim"], 3, out_norm=False)
    hc = m["head_channels"]
    for i in range(HEAD_LAYERS):
        sep(f"head.layers.{i}", cd + 3 if i == 0 else hc, hc, HEAD_KERNEL)
    conv("head.logit", hc, 1, 1, bias=True)
    return shapes


def norm_names(m: dict) -> list[str]:
    """The frozen norms, by name."""
    return sorted(k[:-len(".weight")] for k, s in param_shapes(m).items()
                  if k.endswith(".weight") and len(s) == 1)


class FeelvosRef(Ref):
    """The reference over parameters `sd` (name -> f32 tensor) and the
    model config `m`; `low`: the control."""

    def __init__(self, sd: dict, m: dict, *, low: bool = False):
        self.sd, self.m, self.low = sd, m, low
        self.matching = "bf16"
        self.calibrating: set | None = None

    # ---------------------------------------------------------- layers

    def bn(self, x, name, relu=False):
        """Frozen BatchNorm: x * scale + shift a channel. While
        calibrating, a norm met for the first time first sets its scale
        and shift from x's statistics (see `calibrate`)."""
        w, b = self.sd[f"{name}.weight"], self.sd[f"{name}.bias"]
        if self.calibrating is not None and name not in self.calibrating:
            self.calibrating.add(name)
            dims = (0, 2, 3) if x.shape[2] * x.shape[3] > 1 else (0, 1, 2, 3)
            mean = x.mean(dims).expand_as(w)
            scale = w * torch.rsqrt(x.var(dims, unbiased=False) + BN_EPS)
            w, b = scale, b - mean * scale
            self.sd[f"{name}.weight"], self.sd[f"{name}.bias"] = w, b
        y = x * w[:, None, None] + b[:, None, None]
        return F.relu(y) if relu else y

    def dwconv(self, x, name, stride=1, rate=1):
        """A depthwise conv, symmetric padding."""
        w = self.sd[f"{name}.weight"]
        pad = rate * (w.shape[-1] - 1) // 2
        return F.conv2d(self._q(x), self._q(w), None, stride, pad, rate,
                        x.shape[1])

    def sep(self, x, name, stride=1, rate=1, inner_relu=True,
            out_norm=True):
        """S(c, k, rate, inner_relu) (without `out_norm`: the embedding's
        depthwise, norm, ReLU and pointwise conv with its bias)."""
        if not inner_relu:
            x = F.relu(x)
        x = self.bn(self.dwconv(x, f"{name}.dw", stride, rate),
                    f"{name}.dw_norm", relu=inner_relu)
        x = self.conv(x, f"{name}.pw")
        if not out_norm:
            return x
        return self.bn(x, f"{name}.pw_norm", relu=inner_relu)

    def cbr(self, x, name, norm, stride=1):
        """conv, frozen BatchNorm, ReLU."""
        return self.bn(self.conv(x, name, stride=stride), norm, relu=True)

    # --------------------------------------------------------- encoder

    def trunk(self, img):
        """Xception-65: img (B, 3, H, W) normalized f32 -> (the low-level
        feature (B, 256, H/4, W/4), the exit flow's output (B, 2048, H/os,
        W/os))."""
        x = self.cbr(img, f"{BB}.root_conv1", f"{BB}.root_norm1", stride=2)
        x = self.cbr(x, f"{BB}.root_conv2", f"{BB}.root_norm2")
        low = None
        for name, _, short, stride, rate, inner in units(self.m):
            p = f"{BB}.units.{name}"
            y = x
            for i in range(3):
                y = self.sep(y, f"{p}.sep.{i}", stride if i == 2 else 1,
                             rate, inner)
                if name == "entry2" and i == 1:
                    low = y
            if short == "conv":
                y = y + self.bn(self.conv(x, f"{p}.shortcut", stride=stride),
                                f"{p}.shortcut_norm")
            elif short == "sum":
                y = y + x
            x = y
        return low, x

    def encoder(self, img):
        """img (B, 3, H, W) normalized f32 -> feature (B, h, w, Cd),
        embedding (B, h, w, Ce) at stride 4."""
        m = self.m
        low, x = self.trunk(img)
        a = "encoder.aspp"
        rates = [r * 16 // m["output_stride"] for r in (6, 12, 18)]
        br = [self.cbr(x, f"{a}.conv0", f"{a}.norm0")]
        br += [self.sep(x, f"{a}.sep.{i}", rate=r)
               for i, r in enumerate(rates)]
        pooled = self.cbr(x.mean(dim=(2, 3), keepdim=True), f"{a}.pool_conv",
                          f"{a}.pool_norm")
        br.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        y = self.cbr(torch.cat(br, 1), f"{a}.project", f"{a}.project_norm")
        y = _up(y, low.shape[2:])
        ll = self.cbr(low, "encoder.low_level_proj", "encoder.low_level_norm")
        feat = self.sep(torch.cat([y, ll], 1), "encoder.decoder.0")
        feat = self.sep(feat, "encoder.decoder.1")
        emb = self.sep(feat, "encoder.embedding", out_norm=False)
        return feat.permute(0, 2, 3, 1), emb.permute(0, 2, 3, 1)

    # ------------------------------------------------------------ head

    def head(self, feat, gm, lm, prev, obj_valid):
        """The head over [F, G_o, L_o, P_o] of each object: feat (h, w,
        Cd), the maps (h, w, O) -> logits (h, w, O), absent objects at
        NEG_INF."""
        o = gm.shape[-1]
        f = feat.permute(2, 0, 1)[None].expand(o, -1, -1, -1)
        x = torch.cat([f, *(t.permute(2, 0, 1)[:, None]
                            for t in (gm, lm, prev))], 1)
        for i in range(HEAD_LAYERS):
            x = self.sep(x, f"head.layers.{i}")
        logit = self.conv(x, "head.logit", full=True)
        return logit[:, 0].permute(1, 2, 0) + (1.0 - obj_valid) * NEG_INF


def step(ref: FeelvosRef, feat_t, emb_t, emb0, labels0, emb_prev,
         probs_prev, obj_valid):
    """Frame t's probabilities (h, w, O): global matching against frame
    0's labelled pixels, local matching against frame t-1's argmax, the
    head, a softmax."""
    h, w, ce = emb_t.shape
    o = obj_valid.shape[0]
    gm = ref.global_matching(emb_t.reshape(-1, ce), emb0.reshape(-1, ce),
                             labels0, o).reshape(h, w, o)
    lm = ref.local_matching(emb_t[None], emb_prev[None],
                            probs_prev.argmax(-1)[None], o,
                            ref.m["local_window"])[0]
    return torch.softmax(ref.head(feat_t, gm, lm, probs_prev, obj_valid), -1)


def propagate_clip(ref: FeelvosRef, frames, first_mask, num_objects: int,
                   o: int, last: int | None = None):
    """A clip from its first mask, each frame from the one before it, up
    to frame `last` (default: the clip's end). -> (probs (n, h, w, O),
    features (n, h, w, Cd), embeddings (n, h, w, Ce)), n = last + 1."""
    n = (frames[0] if isinstance(frames, tuple) else frames).shape[0]
    n = n if last is None else last + 1
    feat, emb = encode_frames(ref, frames, range(n))
    ov = object_valid(num_objects, o, feat.device)
    labels0 = key_labels(first_mask, ov)
    probs = [first_probs(first_mask, ov)]
    for t in range(1, n):
        probs.append(step(ref, feat[t], emb[t], emb[0], labels0, emb[t - 1],
                          probs[-1], ov))
    return torch.stack(probs), feat, emb


def calibrate(ref: FeelvosRef, frames, first_mask, num_objects: int) -> None:
    """Set every frozen norm of `ref.sd` in place from seeded frames
    (uint8 RGB (N, H, W, 3) on the device, N >= 2, frames 0 and 1 a clip)
    and frame 0's labels at stride 4: the encoder over all N frames at
    once, then the head on frame 1 (global and local matching against
    frame 0, frame 0's one-hot as the previous probabilities), in f32, in
    one pass. A norm met for the first time takes scale = g / sqrt(var +
    eps) and shift = b - mean scale from its input's mean and variance a
    channel over the batch and the pixels, where g and b are its drawn
    scale and shift; its output then has mean b and standard deviation g
    a channel, whatever the depth.
    The image-pooling branch's norm, one pixel a frame, takes its
    statistics over all its channels at once."""
    ref.calibrating = set()
    try:
        feat, emb = ref.encoder(normalized(frames))
        o = num_objects + 1
        ov = object_valid(num_objects, o, feat.device)
        step(ref, feat[1], emb[1], emb[0], key_labels(first_mask, ov),
             emb[0], first_probs(first_mask, ov), ov)
    finally:
        ref.calibrating = None
