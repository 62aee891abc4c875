"""FEELVOS (Voigtlaender et al., CVPR 2019, arXiv:1902.09513): the
semi-supervised model that MANet's propagation branch descends from.
The port's own (`ModelConfig.arch` "feelvos"); the JAX package has no
counterpart, and the benchmark's plain reference
(`manet_bench/reference/feelvos.py`) is what tests hold it against.

- The encoder (`models/encoder.SeparableEncoder`): DeepLabv3+ on
  Xception-65 with separable ASPP and decoder -> the feature F
  (`decoder_channels` at stride 4) and the embedding (a separable 3x3,
  its norm and ReLU, a 1x1 with a bias to `embedding_dim`, zero-padded
  to `embedding_dim_padded`).
- Matching, distance d = 1 - 2 / (1 + exp(||e_p - e_q||^2)): global
  against frame 0's pixels of each object (kernel 1, prepared once a
  clip), local against frame t-1's pixels of each object within the
  window at stride 4 (kernel 2; `local_downsample` 1 is the published
  setting).
- The dynamic segmentation head (`models/heads.SeparableSegHead`), once
  per object with background as an object: [F, G_o, L_o, P_{t-1,o}]
  through four separable 7x7 layers at `head_channels` and a 1x1 to one
  f32 logit; absent objects at NEG_INF, then a softmax over the objects.
  F's share of the first layer is computed once a frame.

Norms are frozen BatchNorm (`FrozenAffine`, a scale and a shift a
channel), activations in `cfg.dtype`, parameters in f32. There is no
interaction branch and no memory. The batch engine
(`engine/propagate_batch.py`) calls `extract_features`, `prepare_ref`,
`match_prepared`, `start_clip`, `local_map` and `clip_head`, as it does
MANet's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cvpr2020_manet_tpu_torch.config import ModelConfig
from cvpr2020_manet_tpu_torch.device import resolve_device
from cvpr2020_manet_tpu_torch.models.encoder import SeparableEncoder
from cvpr2020_manet_tpu_torch.models.heads import SeparableSegHead
from cvpr2020_manet_tpu_torch.models.layers import init_weights
from cvpr2020_manet_tpu_torch.models.manet import NEG_INF, _nchw, _nhwc
from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    global_matching_prepared, prepare_ref)
from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
    local_matching_cuda)

HEAD_LAYERS, HEAD_KERNEL = 4, 7


class FEELVOS(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        """Weights are drawn on the CPU from `seed` (`init_weights`), then
        moved to `device` (`cuda` unless given); the frozen norms start as
        the identity (scale 1, shift 0)."""
        super().__init__()
        if cfg.arch != "feelvos":
            raise ValueError(f"FEELVOS takes arch 'feelvos', not {cfg.arch!r}")
        if cfg.norm != "frozen" or cfg.head_norm != "frozen":
            raise ValueError("FEELVOS runs frozen BatchNorm: norm and "
                             "head_norm must be 'frozen'")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.encoder = SeparableEncoder(cfg)
        self.head = SeparableSegHead(cfg.decoder_channels + 3,
                                     cfg.head_channels, HEAD_LAYERS,
                                     HEAD_KERNEL, self.dtype)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def extract_features(self, images: torch.Tensor):
        """(B, H, W, 3) -> feature (B, h, w, Cd), embedding (B, h, w,
        Ce_pad)."""
        feat, emb = self.encoder(_nchw(images))
        return _nhwc(feat), _nhwc(emb)

    def prepare_ref(self, ref_emb, ref_onehot, ref_valid=None):
        """Frame 0's embedding (Nk, Ce) bucketed by object for
        `match_prepared`, once a clip."""
        return prepare_ref(ref_emb, ref_onehot, ref_valid)

    def match_prepared(self, query, bucketed):
        """Query rows (Nq, Ce) -> (Nq, O) f32: kernel 1."""
        return global_matching_prepared(query, bucketed)

    def local_map(self, emb_t, prev_emb, prev_probs):
        """Local matching of emb_t (h, w, Ce) against the previous
        frame's embedding and hard labels (the argmax of prev_probs (h, w,
        O)) within the window, at stride 4 -> (h, w, O) f32: kernel 2.
        An object without pixels in the window reads 1."""
        onehot = F.one_hot(prev_probs.argmax(dim=-1),
                           prev_probs.shape[-1]).float()
        return local_matching_cuda(emb_t, prev_emb, onehot,
                                   window=self.cfg.local_window)

    def _maps(self, gm, lm, prev_probs):
        """[G_o, L_o, P_o] of each object: (O, 3, h, w) in the model
        dtype."""
        return torch.stack([gm, lm, prev_probs], 0).permute(3, 0, 1, 2) \
            .to(self.dtype)

    # -- a clip from its first mask (the batch engine) -------------------- #

    def start_clip(self, feat_s, first_oh, obj_valid):
        """What a clip's steps share: the features' share of the head's
        first layer for frames 1 .. T-1 of feat_s (T, h, w, Cd). -> (the
        clip, {}): FEELVOS has no memory to hand back."""
        del first_oh
        return {"ov": obj_valid,
                "head_fp": self.head.feature_part(_nchw(feat_s[1:]))}, {}

    def clip_head(self, clip, i: int, feat_t, gm, lm, prev_probs):
        """Frame i's head from `start_clip`'s clip, its maps (h, w, O) and
        the previous frame's probabilities -> logits (h, w, O) f32, absent
        objects at NEG_INF."""
        del feat_t
        logit = self.head(self._maps(gm, lm, prev_probs),
                          clip["head_fp"][i - 1][None])
        return logit[:, 0].permute(1, 2, 0) + (1.0 - clip["ov"]) * NEG_INF

