"""Plain float32 MANet: the benchmark's reference.

The architecture written out from its definition (MANet, CVPR 2020,
arXiv:2003.13246: a ResNet-101 DeepLabv3+ encoder at output stride 16
with a pixel-embedding head, an interaction head on the scribbled frame,
the gated memory aggregator, and a propagation head fed by global and
local matching). It imports nothing of the program: it works from a
parameter dictionary that the benchmark makes from the seed and hands to
both sides, and it derives everything else (features, embeddings,
matching distances, memories) itself.

Everything runs in float32 with TF32 off (`fp32_math`). `Ref(low=True)`
is the control: the same computation one step below the precision that
the configuration states (activations and weights of the bf16 convs as
per-tensor scaled fp8 e4m3, global matching one step below its backend:
fp8 for bf16, int4 rows for int8, local matching in TF32).

Layouts: maps are (h, w, O) with the object axis last (background first);
convs run in NCHW.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BIG = 1e8          # distance to keys of another label (the sentinel)
NEG_INF = -1e9     # logit of an object that the sequence does not have
FP8_MAX = 448.0    # largest float8_e4m3fn


@contextlib.contextmanager
def fp32_math():
    """TF32 off for matmuls and cuDNN convs while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def stage_blocks(depths):
    """(stage, block, stride, dilation, shortcut) of every bottleneck at
    output stride 16: stages 2 and 3 start at stride 2, stage 4 is
    dilated by 2 with multi-grid (1, 2, 4)."""
    plan = [(1, 1), (2, 1), (2, 1), (1, 2)]
    out = []
    for s, (n, (stride, dil)) in enumerate(zip(depths, plan)):
        for b in range(n):
            mg = (1, 2, 4)[min(b, 2)] if dil > 1 else 1
            out.append((s, b, stride if b == 0 else 1, dil * mg, b == 0))
    return out


def param_shapes(m: dict) -> dict[str, tuple]:
    """Every parameter of the architecture under the model config `m`
    (the `ModelConfig` fields), by name."""
    shapes: dict[str, tuple] = {}

    def conv(name, cin, cout, k, bias=False):
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        if bias:
            shapes[f"{name}.bias"] = (cout,)

    def norm(name, c):
        shapes[f"{name}.weight"] = (c,)
        shapes[f"{name}.bias"] = (c,)

    w = m["backbone_width"]
    bb = "encoder.backbone"
    conv(f"{bb}.stem_conv", 3, w, 7)
    norm(f"{bb}.stem_norm", w)
    cin = w
    for s, b, _, _, first in stage_blocks(m["backbone_depths"]):
        ch = w * 2 ** s
        p = f"{bb}.stage{s + 1}_block{b}"
        conv(f"{p}.conv1", cin, ch, 1)
        norm(f"{p}.norm1", ch)
        conv(f"{p}.conv2", ch, ch, 3)
        norm(f"{p}.norm2", ch)
        conv(f"{p}.conv3", ch, ch * 4, 1)
        norm(f"{p}.norm3", ch * 4)
        if first:
            conv(f"{p}.shortcut", cin, ch * 4, 1)
            norm(f"{p}.shortcut_norm", ch * 4)
        cin = ch * 4
    a = m["aspp_channels"]
    for i, k in enumerate((1, 3, 3, 3, 1)):
        conv(f"encoder.aspp.conv.{i}", cin, a, k)
    conv("encoder.aspp.conv.5", 5 * a, a, 1)
    for i in range(6):
        norm(f"encoder.aspp.norm.{i}", a)
    ll, cd = m["low_level_channels"], m["decoder_channels"]
    conv("encoder.low_level_proj", w * 4, ll, 1)
    norm("encoder.low_level_norm", ll)
    conv("encoder.decoder_conv0", a + ll, cd, 3)
    norm("encoder.decoder_norm0", cd)
    conv("encoder.decoder_conv1", cd, cd, 3)
    norm("encoder.decoder_norm1", cd)
    conv("encoder.embedding_head", cd, m["embedding_dim"], 1, bias=True)
    hc, cma = m["head_channels"], m["ma_channels"]
    conv("interaction_head.stack.conv0", cd + 3, hc, 3)
    norm("interaction_head.stack.norm0", hc)
    conv("interaction_head.stack.conv1", hc, hc, 3)
    norm("interaction_head.stack.norm1", hc)
    conv("interaction_head.int_feature", hc, cma, 3, bias=True)
    conv("interaction_head.logit", cma, 1, 1, bias=True)
    conv("propagation_head.stack.conv0", cd + 3 + cma, hc, 3)
    for i in range(3):
        norm(f"propagation_head.stack.norm{i}", hc)
        if i:
            conv(f"propagation_head.stack.conv{i}", hc, hc, 3)
    conv("propagation_head.logit", hc, 1, 1, bias=True)
    conv("memory_aggregator.gate", 2 * cma, cma, 3, bias=True)
    return shapes


def normalize_distance(d: torch.Tensor) -> torch.Tensor:
    """Squared distance -> [0, 1): 1 - 2 / (1 + exp(min(d, 30)))."""
    return 1.0 - 2.0 / (1.0 + torch.exp(torch.clamp(d, max=30.0)))


def _rounded(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """q in value, x's gradient (the straight-through rule), so that the
    control trains through its rounding."""
    return x + (q - x).detach()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale per tensor, back in f32."""
    d = x.detach()
    s = d.abs().amax().clamp(min=1e-12) / FP8_MAX
    return _rounded(x, (d / s).to(torch.float8_e4m3fn).float() * s)


def int4_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row through symmetric int4 ([-7, 7]), back in f32."""
    d = x.detach()
    s = d.abs().amax(-1, keepdim=True).clamp(min=1e-12) / 7.0
    return _rounded(x, torch.round(d / s).clamp(-7, 7) * s)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (nearest), in f32."""
    i = x.detach().contiguous().view(torch.int32)
    return _rounded(x, ((i + 0x1000) & ~0x1FFF).view(torch.float32))


def _up(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of NCHW, half-pixel centres (antialiased when it
    shrinks)."""
    shrink = size[0] < x.shape[2]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrink)


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of (B, h, w, C)."""
    return _up(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


class Ref:
    """The reference over parameters `sd` (name -> f32 tensor) and the
    model config `m`. `matching`: the configuration's global-matching
    backend ("bf16" or "int8"); it only decides what the control (`low`)
    rounds the matching to."""

    def __init__(self, sd: dict, m: dict, *, matching: str = "bf16",
                 low: bool = False):
        self.sd, self.m, self.low = sd, m, low
        self.matching = matching
        self.groups = m["gn_groups"]

    # ---------------------------------------------------------- layers

    def _q(self, x):
        return fp8(x) if self.low else x

    def conv(self, x, name, stride=1, padding=None, dilation=1, full=False):
        """A conv; `full`: one the configuration runs in f32 (the logit
        convs), which the control leaves in f32."""
        w = self.sd[f"{name}.weight"]
        b = self.sd.get(f"{name}.bias")
        if padding is None:
            padding = dilation * (w.shape[-1] - 1) // 2
        if not full:
            x, w = self._q(x), self._q(w)
        return F.conv2d(x, w, b, stride, padding, dilation)

    def gn(self, x, name, groups=None):
        return F.group_norm(x, groups or self.groups, self.sd[f"{name}.weight"],
                            self.sd[f"{name}.bias"], 1e-6)

    def cgr(self, x, name, norm, groups=None, **kw):
        """conv, group norm, relu."""
        return F.relu(self.gn(self.conv(x, name, **kw), norm, groups))

    # --------------------------------------------------------- encoder

    def encoder(self, img):
        """img (B, 3, H, W) normalized f32 -> feature (B, h, w, Cd),
        embedding (B, h, w, Ce) at stride 4 (Ce = embedding_dim; the
        program's zero padding adds nothing to any distance)."""
        m, bb = self.m, "encoder.backbone"
        x = self.cgr(img, f"{bb}.stem_conv", f"{bb}.stem_norm", stride=2,
                     padding=3)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        low = None
        for s, b, stride, dil, first in stage_blocks(m["backbone_depths"]):
            p = f"{bb}.stage{s + 1}_block{b}"
            y = self.cgr(x, f"{p}.conv1", f"{p}.norm1")
            y = self.cgr(y, f"{p}.conv2", f"{p}.norm2", stride=stride,
                         padding=dil, dilation=dil)
            y = self.gn(self.conv(y, f"{p}.conv3"), f"{p}.norm3")
            r = (self.gn(self.conv(x, f"{p}.shortcut", stride=stride,
                                   padding=0), f"{p}.shortcut_norm")
                 if first else x)
            x = F.relu(y + r)
            if s == 0:
                low = x
        a = "encoder.aspp"
        br = [self.cgr(x, f"{a}.conv.0", f"{a}.norm.0")]
        for i, rate in enumerate((6, 12, 18), start=1):
            br.append(self.cgr(x, f"{a}.conv.{i}", f"{a}.norm.{i}",
                               padding=rate, dilation=rate))
        pooled = self.cgr(x.mean(dim=(2, 3), keepdim=True), f"{a}.conv.4",
                          f"{a}.norm.4", groups=1)
        br.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        y = self.cgr(torch.cat(br, 1), f"{a}.conv.5", f"{a}.norm.5")
        y = _up(y, low.shape[2:])
        ll = self.cgr(low, "encoder.low_level_proj", "encoder.low_level_norm",
                      groups=math.gcd(self.groups, m["low_level_channels"]))
        y = self.cgr(torch.cat([y, ll], 1), "encoder.decoder_conv0",
                     "encoder.decoder_norm0")
        feat = self.cgr(y, "encoder.decoder_conv1", "encoder.decoder_norm1")
        emb = self.conv(feat, "encoder.embedding_head")
        return feat.permute(0, 2, 3, 1), emb.permute(0, 2, 3, 1)

    # ----------------------------------------------------------- heads

    @staticmethod
    def _objects(maps):
        """(h, w, O) -> (O, 1, h, w)."""
        return maps.permute(2, 0, 1)[:, None]

    def interact(self, feat, pos, neg, prev):
        """feat (h, w, Cd), pos / neg scribbles and the previous masks
        (h, w, O) -> (interaction features (O, Cma, h, w), logits
        (h, w, O))."""
        o = pos.shape[-1]
        f = feat.permute(2, 0, 1)[None].expand(o, -1, -1, -1)
        x = torch.cat([f, self._objects(pos), self._objects(neg),
                       self._objects(prev)], 1)
        p = "interaction_head"
        x = self.cgr(x, f"{p}.stack.conv0", f"{p}.stack.norm0")
        x = self.cgr(x, f"{p}.stack.conv1", f"{p}.stack.norm1")
        fe = self.conv(x, f"{p}.int_feature")
        logit = self.conv(F.relu(fe), f"{p}.logit", full=True)
        return fe, logit[:, 0].permute(1, 2, 0)

    def aggregate(self, fe, mem, first: bool):
        """The gated memory: w = sigmoid(gate([f, m])), w f + (1 - w) m."""
        if first:
            return fe
        w = torch.sigmoid(self.conv(torch.cat([fe, mem], 1),
                                    "memory_aggregator.gate"))
        return w * fe + (1.0 - w) * mem

    def head(self, feat, gm, lm, prev, mem):
        """The propagation head over [feature, global map, local map,
        previous masks, memory] of each object of each frame: feat (B, h,
        w, Cd), maps (B, h, w, O), mem (O, Cma, h, w) -> logits (B, h, w,
        O)."""
        b, h, w, o = gm.shape

        def objects(maps):
            return maps.permute(0, 3, 1, 2).reshape(b * o, 1, h, w)

        f = feat.permute(0, 3, 1, 2)[:, None].expand(-1, o, -1, -1, -1)
        m = mem[None].expand(b, -1, -1, -1, -1)
        x = torch.cat([f.reshape(b * o, -1, h, w), objects(gm), objects(lm),
                       objects(prev), m.reshape(b * o, -1, h, w)], 1)
        p = "propagation_head"
        for i in range(3):
            x = self.cgr(x, f"{p}.stack.conv{i}", f"{p}.stack.norm{i}")
        logit = self.conv(x, f"{p}.logit", full=True)
        return logit.reshape(b, o, h, w).permute(0, 2, 3, 1)

    # -------------------------------------------------------- matching

    def _match_rows(self, x):
        if not self.low:
            return x
        return int4_rows(x) if self.matching == "int8" else fp8(x)

    def global_matching(self, q, keys, labels, o: int):
        """Normalized nearest-neighbour distance of each query row
        (N, C) to the key rows (K, C) of each object: labels (K,) in
        [0, O) or -1 (unlabelled) -> (N, O); an object without keys
        reads 1."""
        q, keys = self._match_rows(q.float()), self._match_rows(keys.float())
        out = torch.full((q.shape[0], o), BIG, device=q.device)
        qn = q.square().sum(-1, keepdim=True)
        for obj in range(o):
            k = keys[labels == obj]
            if k.shape[0] == 0:
                continue
            kn = k.square().sum(-1)
            rows = max(1, (1 << 28) // k.shape[0])
            for s in range(0, q.shape[0], rows):
                d = qn[s:s + rows] + kn - 2.0 * (q[s:s + rows] @ k.T)
                out[s:s + rows, obj] = d.clamp(min=0.0).amin(1)
        return normalize_distance(out.clamp(max=BIG))

    def local_matching(self, q, k, labels, o: int, window: int):
        """Normalized distance of each pixel of q (B, h, w, C) to the
        pixels of k (B, h, w, C) of each object within `window` in both
        axes: labels (B, h, w) -> (B, h, w, O)."""
        if self.low:
            q, k = tf32(q), tf32(k)
        b, h, w, _ = q.shape
        n = 2 * window + 1
        kp = F.pad(k, (0, 0, window, window, window, window))
        lp = F.pad(labels, (window, window, window, window), value=-1)
        qn = q.square().sum(-1)[..., None]
        best = torch.full((b, h, w, o), BIG, device=q.device)
        objs = torch.arange(o, device=q.device)
        for dy in range(n):
            rows = kp[:, dy:dy + h]
            win = rows.unfold(2, n, 1)                      # (B, h, w, C, n)
            cross = torch.einsum("bhwc,bhwcn->bhwn", q, win)
            kn = rows.square().sum(-1).unfold(2, n, 1)      # (B, h, w, n)
            d = (qn + kn - 2.0 * cross).clamp(min=0.0)
            lab = lp[:, dy:dy + h].unfold(2, n, 1)          # (B, h, w, n)
            hit = lab[..., None] == objs                    # (B, h, w, n, O)
            best = torch.minimum(best, torch.where(hit, d[..., None], BIG)
                                 .amin(3))
        return normalize_distance(best)

    # ---------------------------------------------------- one frame step

    def propagate(self, feat, emb, gm, prev_emb, prev_probs, mem, obj_valid):
        """Propagation of B frames, each from the frame before it: local
        matching against that frame's hard labels at half resolution,
        then the head. All maps (B, h, w, .) -> logits (B, h, w, O) with
        absent objects at NEG_INF."""
        h, w = emb.shape[1:3]
        o = gm.shape[-1]
        s = self.m["local_downsample"]
        lab = prev_probs.argmax(-1)
        if s > 1:
            hw = (h // s, w // s)
            lm = self.local_matching(resize(emb, hw), resize(prev_emb, hw),
                                     lab[:, s // 2::s, s // 2::s], o,
                                     self.m["local_window"])
            lm = resize(lm, (h, w))
        else:
            lm = self.local_matching(emb, prev_emb, lab, o,
                                     self.m["local_window"])
        logits = self.head(feat, gm, lm, prev_probs, mem)
        return logits + (1.0 - obj_valid) * NEG_INF
