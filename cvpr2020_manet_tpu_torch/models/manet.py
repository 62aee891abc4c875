"""MANet core model (SURVEY.md C2), PyTorch port of `models/manet.py`.

One `nn.Module` with the reference's four capabilities as methods:

- `extract_features` — the once-per-video encoder
- `interact`         — scribble branch on the annotated frame
- `aggregate_memory` — gated round fusion (MA)
- `propagate`        — matching + decoder head, one frame

The public methods take and return the JAX package's layout (NHWC maps,
trailing object axis, object-folded features (O, h, w, C)) so tests
compare like with like; the convs run in NCHW inside (as views: the
permutes are free and cuDNN reads the channels-last strides).

Matching inside `propagate` goes through the bucketed global-matching and
the local-matching wrappers: the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors. With `trainable_matching=True` (the trainers) it
goes through the argmin-routed `torch.autograd.Function`s of
`ops/trainable.py` instead, whose forwards are the kernels' argmin
variants; inference keeps the leaner kernels.

Norms: `cfg.norm` (backbone and encoder) and `cfg.head_norm` (the heads'
conv stacks), any of `models/layers.make_norm`'s. With 'bn' / 'syncbn'
the methods use batch statistics and update the running averages, as the
JAX model's `apply(variables, ..., mutable=["batch_stats"])`; the engines,
export and the trainers refuse them (`config.check_params_only`), since
JAX's versions pass `params` alone.

`matching_backend="int8"` is the opt-in int8 serving mode (the JAX
model's `pallas_int8`): global matching quantizes the memory and the
queries to int8 and runs the int8 tensor-core kernel. Training
(`trainable_matching`) stays full precision, and local matching stays
full precision in both modes, as in the JAX model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cvpr2020_manet_tpu_torch.config import ModelConfig
from cvpr2020_manet_tpu_torch.device import resolve_device
from cvpr2020_manet_tpu_torch.models.encoder import Encoder
from cvpr2020_manet_tpu_torch.models.heads import (
    DynamicSegHead, InteractionHead, MemoryAggregator)
from cvpr2020_manet_tpu_torch.models.layers import (
    init_weights, resize_bilinear, resize_nearest)
from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    global_matching_prepared, global_matching_prepared_int8, prepare_ref,
    prepare_ref_int8)
from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
    local_matching_cuda)
from cvpr2020_manet_tpu_torch.ops.trainable import (
    GlobalMatchingTrainable, LocalMatchingTrainable)

NEG_INF = -1e9   # logit of an invalid (padding) object
MATCHING_BACKENDS = ("auto", "int8")


def _fold_maps(maps: torch.Tensor) -> torch.Tensor:
    """(h, w, O) -> (O, 1, h, w)."""
    return maps.permute(2, 0, 1)[:, None]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MANet(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 trainable_matching: bool = False,
                 matching_backend: str = "auto"):
        """Weights are drawn on the CPU from `torch.Generator` seeded with
        `seed` (the same weights on every device), then moved to `device`
        (`cuda` unless given). `trainable_matching`: match through the
        argmin-routed Functions (training), as the JAX model's flag of the
        same name does. `matching_backend`: "auto" (the full-precision
        kernels) or "int8" (int8 global matching for serving)."""
        super().__init__()
        if cfg.arch != "manet":
            raise ValueError(f"MANet takes arch 'manet', not {cfg.arch!r}")
        if matching_backend not in MATCHING_BACKENDS:
            raise ValueError(f"matching_backend={matching_backend!r}: one of "
                             f"{MATCHING_BACKENDS}")
        self.trainable_matching = trainable_matching
        self.matching_backend = matching_backend
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        cd, cma = cfg.decoder_channels, cfg.ma_channels
        self.encoder = Encoder(cfg)
        self.interaction_head = InteractionHead(
            cd + 3, cfg.head_channels, cma, cfg.head_norm, cfg.gn_groups,
            self.dtype)
        self.propagation_head = DynamicSegHead(
            cd + 3 + cma, cfg.head_channels, cfg.head_norm, cfg.gn_groups,
            self.dtype)
        self.memory_aggregator = MemoryAggregator(cma, self.dtype)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    # ------------------------------------------------------------------ #

    def extract_features(self, images: torch.Tensor):
        """(B, H, W, 3) -> feature (B, h, w, Cd), embedding (B, h, w, Ce_pad)."""
        feat, emb = self.encoder(_nchw(images))
        return _nhwc(feat), _nhwc(emb)

    def interact(self, feature, pos_scr, neg_scr, prev_mask):
        """feature (h, w, Cd); pos/neg scribbles and previous-round
        probabilities (h, w, O) -> (interaction features (O, h, w, Cma),
        logits (h, w, O) f32)."""
        o = pos_scr.shape[-1]
        dt = feature.dtype
        f = feature.permute(2, 0, 1)[None].expand(o, -1, -1, -1)
        x = torch.cat([f, _fold_maps(pos_scr).to(dt), _fold_maps(neg_scr).to(dt),
                       _fold_maps(prev_mask).to(dt)], dim=1)
        int_feats, logits = self.interaction_head(x)
        return _nhwc(int_feats), logits[:, 0].permute(1, 2, 0)

    def aggregate_memory(self, int_feats, memory, is_first_round: bool):
        """Gated fusion of this round's interaction features (O, h, w, Cma)
        into the memory; the first round seeds it with the features."""
        if is_first_round:
            return int_feats.to(torch.promote_types(int_feats.dtype,
                                                    memory.dtype))
        return _nhwc(self.memory_aggregator(_nchw(int_feats), _nchw(memory)))

    # -- decomposed head stage 1 ---------------------------------------- #
    # conv0 of the propagation head is linear in its input, and two of its
    # three input blocks are constant within a round (backbone features
    # per sequence, MA memory per round): their conv0 contributions are
    # computed once per round, leaving the 3 per-frame map channels.

    def _head_conv0_slice(self, x: torch.Tensor, lo: int, hi: int):
        """conv0 over input channels [lo, hi) of NCHW x, in the model dtype."""
        k = self.propagation_head.stack.conv0.weight[:, lo:hi]
        return F.conv2d(x.to(self.dtype), k.to(self.dtype), padding=1)

    def head_feat_contrib(self, feat):
        """(T, h, w, Cd) backbone features -> their conv0 contribution."""
        return _nhwc(self._head_conv0_slice(_nchw(feat), 0,
                                            self.cfg.decoder_channels))

    def head_mem_contrib(self, int_memory):
        """(O, h, w, Cma) MA memory -> its conv0 contribution."""
        cf = self.cfg.decoder_channels
        return _nhwc(self._head_conv0_slice(
            _nchw(int_memory), cf + 3, cf + 3 + self.cfg.ma_channels))

    def propagate(self, feature_t, emb_t, ref_emb, ref_onehot, ref_valid,
                  global_map_prev, prev_emb, prev_mask, int_memory,
                  obj_valid, gmap_override=None, head_pre=None):
        """Propagation branch for one frame.

        feature_t (h, w, Cd), emb_t (h, w, Ce): current frame.
        ref_emb (Nk, Ce), ref_onehot (Nk, O), ref_valid (Nk,) | None: the
            matching memory (annotated-frame pixels).
        global_map_prev (h, w, O): running-min global map of this frame.
        prev_emb (h, w, Ce), prev_mask (h, w, O): previous frame in the
            sweep and its probabilities (local matching input).
        int_memory (O, h, w, Cma): aggregated interaction features.
        obj_valid (O,): 1 for live objects (index 0 = background).
        gmap_override (h, w, O) | None: a global matching map computed
            outside (the evaluator matches all frames in one launch).
        head_pre (O, h, w, C) | None: precomputed feature + memory conv0
            contributions (decomposed head).

        Returns (logits (h, w, O) f32, fused global map (h, w, O)).
        """
        if gmap_override is not None:
            gm = gmap_override
        else:
            h, w, ce = emb_t.shape
            gm = self._global_matching(
                emb_t.reshape(-1, ce), ref_emb, ref_onehot,
                ref_valid).reshape(h, w, global_map_prev.shape[-1])
        gm = torch.minimum(gm, global_map_prev)            # C8 min-fusion
        lm = self.local_map(emb_t, prev_emb, prev_mask)

        o = gm.shape[-1]
        dt = feature_t.dtype
        maps = [_fold_maps(gm).to(dt), _fold_maps(lm).to(dt),
                _fold_maps(prev_mask).to(dt)]
        if head_pre is not None:
            cf = self.cfg.decoder_channels
            pre0 = self._head_conv0_slice(torch.cat(maps, dim=1), cf, cf + 3) \
                + _nchw(head_pre).to(self.dtype)
            logits = self.propagation_head(None, pre0=pre0)
        else:
            f = feature_t.permute(2, 0, 1)[None].expand(o, -1, -1, -1)
            x = torch.cat([f, *maps, _nchw(int_memory).to(dt)], dim=1)
            logits = self.propagation_head(x)
        logits = logits[:, 0].permute(1, 2, 0)             # (h, w, O) f32
        logits = logits + (1.0 - obj_valid) * NEG_INF
        return logits, gm

    def local_map(self, emb_t, prev_emb, prev_mask):
        """Local matching of emb_t (h, w, Ce) against the previous frame's
        embedding and hard labels (the argmax of prev_mask (h, w, O)), at
        reduced resolution when local_downsample > 1 -> (h, w, O) f32."""
        h, w = emb_t.shape[:2]
        prev_onehot = F.one_hot(prev_mask.argmax(dim=-1),
                                prev_mask.shape[-1]).float()
        s = self.cfg.local_downsample
        if s > 1:
            hw = (h // s, w // s)
            lm = self._local_matching(
                resize_bilinear(emb_t, hw), resize_bilinear(prev_emb, hw),
                resize_nearest(prev_onehot, hw))
            return resize_bilinear(lm, (h, w))
        return self._local_matching(emb_t, prev_emb, prev_onehot)

    # -- a clip from its first mask (the batch engine) -------------------- #

    def start_clip(self, feat_s, first_oh, obj_valid):
        """What a clip's steps share, from its features (T, h, w, Cd) and
        first mask's one-hot (h, w, O): the interaction memory seeded from
        the mask (which stands in for the first round's scribbles) and the
        decomposed head's per-frame feature and per-clip memory conv0
        contributions. -> (the clip, {"int_mem": (O, h, w, Cma)}: the
        state that a caller may ask to have handed back)."""
        pos = first_oh
        neg = (pos.amax(dim=-1, keepdim=True) - pos) * obj_valid
        int_feats, _ = self.interact(feat_s[0], pos, neg, first_oh)
        int_mem = self.aggregate_memory(int_feats,
                                        torch.zeros_like(int_feats), True)
        clip = {"ov": obj_valid, "head_fp": self.head_feat_contrib(feat_s),
                "head_mp": self.head_mem_contrib(int_mem)}
        return clip, {"int_mem": int_mem}

    def clip_head(self, clip, i: int, feat_t, gm, lm, prev_probs):
        """Frame i's head from `start_clip`'s clip, its global and local
        maps and the previous frame's probabilities (h, w, O) -> logits
        (h, w, O) f32, absent objects at NEG_INF: `propagate`'s decomposed
        head with no running minimum (the global map is against frame 0
        alone, each d in [0, 1])."""
        dt = feat_t.dtype
        maps = torch.cat([_fold_maps(m).to(dt) for m in (gm, lm, prev_probs)],
                         dim=1)
        cf = self.cfg.decoder_channels
        pre0 = self._head_conv0_slice(maps, cf, cf + 3) + _nchw(
            clip["head_fp"][i][None] + clip["head_mp"]).to(self.dtype)
        logits = self.propagation_head(None, pre0=pre0)[:, 0].permute(1, 2, 0)
        return logits + (1.0 - clip["ov"]) * NEG_INF

    def prepare_ref(self, ref_emb, ref_onehot, ref_valid=None):
        """The matching reference (Nk, Ce) bucketed by object for
        `match_prepared`, in the model's matching backend (int8: quantized
        once here). A caller that matches many queries against one
        reference prepares it once."""
        if self.matching_backend == "int8":
            return prepare_ref_int8(ref_emb, ref_onehot, ref_valid)
        return prepare_ref(ref_emb, ref_onehot, ref_valid)

    def match_prepared(self, query, bucketed):
        """Query rows (Nq, Ce) against a `prepare_ref` reference -> (Nq, O)
        f32: one global-matching launch (int8: kernel 3, else kernel 1)."""
        if self.matching_backend == "int8":
            return global_matching_prepared_int8(query, bucketed)
        return global_matching_prepared(query, bucketed)

    def _global_matching(self, query, ref_emb, ref_onehot, ref_valid):
        if self.trainable_matching:
            gate = ref_onehot
            if ref_valid is not None:
                gate = gate * ref_valid.to(gate.dtype)[:, None]
            return GlobalMatchingTrainable.apply(query, ref_emb, gate)
        if self.matching_backend != "int8":
            # query and reference meet in their promoted type, as in JAX: a
            # bf16 query against the streaming engine's f32 memory is f32
            dt = torch.promote_types(query.dtype, ref_emb.dtype)
            query, ref_emb = query.to(dt), ref_emb.to(dt)
        return self.match_prepared(
            query, self.prepare_ref(ref_emb, ref_onehot, ref_valid))

    def _local_matching(self, query, prev, prev_onehot):
        if self.trainable_matching:
            return LocalMatchingTrainable.apply(query, prev, prev_onehot,
                                                self.cfg.local_window)
        return local_matching_cuda(query, prev, prev_onehot,
                                   window=self.cfg.local_window)
