"""Interactive evaluation engine, PyTorch port of `engine/evaluator.py`.

Per sequence the encoder runs once (`start_sequence`, in 8-frame chunks
over a padded frame bucket). Per round (`dispatch_round`):

1. the interaction head and the MA memory gate run on the annotated frame
   (`_interaction`); the global-map memory relaxes toward 1.0 by
   `gmap_refresh`, or resets with `ablate_memory`;
2. the matching reference is the annotated frame's pixels (`min_fused`
   memory) or, with `matching_memory="stacked"`, every round's annotated
   pixels so far: this round's slot of the stacked memory is written in
   place and the live slots (`live_page_bucket`) are matched. The
   reference is bucketed by object once (`MANet.prepare_ref`, int8 for a
   model with `matching_backend="int8"`) and one global-matching launch
   per sweep call (`MANet.match_prepared`) covers its frames. With a
   `cp_mesh` the reference rows shard over the mesh's context members
   instead, and each member matches its shard (`parallel/cp_matching.py`);
3. a (T-1)-step sweep visits frames annot+1 .. T-1, then annot-1 .. 0,
   resetting its carry to the interaction output where the backward sweep
   starts; each step runs local matching, min-fusion, the decomposed
   propagation head and a softmax;
4. probabilities are upsampled, argmaxed and bit-packed (`_masks_impl`).
   The monolithic round (`round_segments=1`) packs every frame at its end
   and `collect_round` downloads them; a segmented round splits the sweep
   into `round_segments` spans and hands each span's packed masks to the
   download pool while the next span computes. Both give the same masks.

Frames come as host-normalized floats or as raw uint8 RGB, which is
padded with the ImageNet mean byte and normalized on the device.

Everything runs under `torch.inference_mode()` on the evaluator's device
(`cuda` unless the caller passes another).

The helpers the serving engines share with the evaluator live here too:
the mask bit-packing, the object, mask-bit and live-page buckets, and the
download pool.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.config import Config, check_params_only
from cvpr2020_manet_tpu_torch.data.davis import IMAGENET_MEAN
from cvpr2020_manet_tpu_torch.device import resolve_device
from cvpr2020_manet_tpu_torch.interactive.scribbles import (
    annotated_frames, scribbles2mask)
from cvpr2020_manet_tpu_torch.models.layers import resize_bilinear
from cvpr2020_manet_tpu_torch.models.manet import NEG_INF, MANet
from cvpr2020_manet_tpu_torch.parallel.cp_matching import (
    check_cp_engine, cp_match_flat)
from cvpr2020_manet_tpu_torch.utils.ingest import preprocess_frames

# One process-wide pool for mask downloads (threads start on first use):
# the serving engines hand each packed mask's device-to-host copy to it,
# so that the copy overlaps the next frames' device work.
_FETCH_POOL = concurrent.futures.ThreadPoolExecutor(
    max_workers=4, thread_name_prefix="mask-fetch")

# The ImageNet mean as bytes: uint8 frames are padded with it, so that the
# padding normalizes to about 0.0, as the float path's zero padding does.
_MEAN_U8 = np.round(IMAGENET_MEAN * 255).astype(np.uint8)


def pad_image_to(x: np.ndarray, multiple: int) -> np.ndarray:
    """Pad trailing spatial edges of (..., H, W, C) to a stride multiple."""
    h, w = x.shape[-3], x.shape[-2]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph == 0 and pw == 0:
        return x
    return np.pad(x, [(0, 0)] * (x.ndim - 3) + [(0, ph), (0, pw), (0, 0)])


def pack_labels(lab, bits: int):
    """Bit-pack uint8 labels along the trailing (W) axis (torch or numpy):
    8 px/byte at 1 bit, 4 at 2 bits, 2 at 4 bits."""
    if bits == 1:
        acc = lab[..., 0::8]
        for i in range(1, 8):
            acc = acc | (lab[..., i::8] << i)
        return acc
    if bits == 2:
        return (lab[..., 0::4] | (lab[..., 1::4] << 2)
                | (lab[..., 2::4] << 4) | (lab[..., 3::4] << 6))
    if bits == 4:
        return lab[..., 0::2] | (lab[..., 1::2] << 4)
    return lab


def mask_bits_for_labels(num_labels: int) -> int:
    """Bits/px for the LIVE label count of a sequence."""
    if num_labels <= 2:
        return 1
    if num_labels <= 4:
        return 2
    if num_labels <= 16:
        return 4
    return 8


def aligned_mask_bits(num_labels: int, w_pad: int) -> int:
    """mask_bits_for_labels widened until the packed W axis is whole-byte
    aligned (the strided pack slices need W % (8/bits) == 0)."""
    bits = mask_bits_for_labels(num_labels)
    while w_pad % (8 // bits):
        bits *= 2
    return bits


def object_bucket_for(num_objects: int | None, o_max: int) -> int:
    """Padded object-axis size for a sequence (4 when it fits, else the
    full bucket)."""
    if num_objects is None:
        return o_max
    for b in sorted({min(4, o_max), o_max}):
        if num_objects + 1 <= b:
            return b
    return o_max


def bucket_mask_bits(o_bucket: int) -> int:
    """Bits per pixel of the packed masks of an object bucket (the batch
    engine packs at the bucket, not at the live label count)."""
    if o_bucket <= 4:
        return 2
    if o_bucket <= 16:
        return 4
    return 8


def live_page_bucket(rounds: int, capacity: int) -> int:
    """Memory pages to match: the filled count rounded up to a power of 2,
    capped at `capacity` (at least 1)."""
    r = max(1, min(rounds, capacity))
    p = 1
    while p < r:
        p *= 2
    return min(p, capacity)


def downsample_mask_max(m: np.ndarray, stride: int) -> np.ndarray:
    """(H, W, O) -> (H/s, W/s, O) presence max-pool, so that thin scribble
    lines survive the step down to feature resolution."""
    h, w, o = m.shape
    return m.reshape(h // stride, stride, w // stride, stride, o).max((1, 3))


def unpack_labels(packed: np.ndarray, bits: int) -> np.ndarray:
    """Inverse of `pack_labels`: (..., W // ppb) uint8 -> (..., W) uint8."""
    if bits == 8:
        return packed
    n = 8 // bits
    mask = (1 << bits) - 1
    out = np.empty((*packed.shape[:-1], packed.shape[-1] * n), np.uint8)
    for i in range(n):
        np.bitwise_and(packed >> (bits * i) if i else packed, mask,
                       out=out[..., i::n])
    return out


@dataclasses.dataclass
class RoundHandle:
    """Device outputs of one dispatched round, not yet downloaded."""
    pk: int                 # mask bits/px
    annot: int              # annotated frame index
    nf: int                 # actual (unpadded) frame count
    t_bucket: int
    masks: Any = None       # monolithic: (T, H, W * pk / 8) packed, device
    annot_mask: Any = None  # segmented: Future of the annotated frame's mask
    seg_masks: list | None = None   # segmented: [(start, count, Future)]


@dataclasses.dataclass
class SequenceState:
    """Per-sequence device state, kept across rounds."""
    feat: torch.Tensor | None        # (T, h, w, Cd)
    emb: torch.Tensor | None         # (T, h, w, Ce)
    prev_masks: torch.Tensor | None  # (T, h, w, O) probabilities
    gmap_mem: torch.Tensor | None    # (T, h, w, O) running-min global maps
    int_mem: torch.Tensor | None     # (O, h, w, Cma) f32
    round_idx: int
    num_frames: int                  # actual (unpadded) frame count
    # stacked matching memory only: the annotated pixels of every round so
    # far, one slot of h*w rows per round, written in place
    mem_emb: torch.Tensor | None = None      # (R_max * h * w, Ce)
    mem_onehot: torch.Tensor | None = None   # (R_max * h * w, O) f32


def release_state(state: SequenceState, keep_features: bool = False) -> None:
    """Drop a sequence state's device tensors now (not at GC time);
    `keep_features` keeps feat/emb for the same sequence's next set."""
    state.prev_masks = state.gmap_mem = state.int_mem = None
    state.mem_emb = state.mem_onehot = None
    if not keep_features:
        state.feat = state.emb = None


def _download(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class Evaluator:
    """Runs a model against an `InteractiveSession`."""

    def __init__(self, cfg: Config, model: MANet, device=None,
                 ablate_memory: bool = False, cp_mesh=None):
        """`ablate_memory`: switch off the cross-round memories (the
        global-map min-fusion and the MA gate), so that every round
        conditions only on its own scribbles and the previous masks.
        `cp_mesh`: a `parallel.mesh.Mesh`; the matching-memory rows then
        shard over its context members (`parallel/cp_matching.py`, the
        allgather schedule)."""
        check_params_only(model.cfg, "Evaluator")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.o = cfg.model.max_objects + 1
        self.stride = cfg.model.feature_stride
        self.ablate_memory = ablate_memory
        self.memory_mode = cfg.eval.matching_memory
        if self.memory_mode not in ("min_fused", "stacked"):
            raise ValueError(f"matching_memory={self.memory_mode!r}")
        self.cp_mesh = cp_mesh
        if cp_mesh is not None:
            check_cp_engine(cp_mesh, self.device, model.matching_backend,
                            "eval")
        self.round_latencies: list[float] = []
        # (frame bucket, object bucket, seconds) per round: callers report
        # latency per bucket (DAVIS val spans the 32/64/104 frame buckets;
        # a global p50 hides the long sequences' cost)
        self.round_records: list[tuple[int, int, float]] = []

    # ---------------- device graph of one round ------------------------ #

    def _interaction(self, feat, emb, raster, annot, prev_masks, gmap_mem,
                     int_mem, is_first, obj_valid):
        """Scribble pooling, interaction branch, MA update, the global-map
        memory's refresh, matching reference labels. Returns (int_probs,
        int_mem, gmap_mem, ref_emb, ref_onehot)."""
        model = self.model
        h, w = feat.shape[1:3]
        o = prev_masks.shape[-1]
        s = self.stride
        # raster (H_pad, W_pad), -1 = unscribbled -> per-object presence
        # max-pooled to feature stride
        raster = raster.long()
        scr = (raster >= 0).float()[..., None]
        oh = F.one_hot(torch.clamp(raster, 0, o - 1), o).float() * scr

        def blockmax(x):
            return x.reshape(h, s, w, s, o).amax(dim=(1, 3))

        pos_scr = blockmax(oh)
        neg_scr = blockmax(scr - oh)
        int_feats, int_logits = model.interact(feat[annot], pos_scr, neg_scr,
                                               prev_masks[annot])
        if self.ablate_memory:
            is_first = True                         # no MA fusion
            gmap_mem = torch.ones_like(gmap_mem)    # no min-fusion
        elif self.cfg.eval.gmap_refresh > 0.0:
            # leaky min-fusion: stored minima relax toward 1.0 once per
            # round
            r = self.cfg.eval.gmap_refresh
            gmap_mem = 1.0 - (1.0 - gmap_mem) * (1.0 - r)
        int_mem = model.aggregate_memory(int_feats, int_mem, is_first)
        int_logits = int_logits + (1.0 - obj_valid) * NEG_INF
        int_probs = torch.softmax(int_logits, dim=-1)
        # matching reference labels: the interaction argmax, overridden by
        # the scribbles themselves (scribbled pixels are ground truth)
        lab = int_probs.argmax(dim=-1)
        scribbled = pos_scr.amax(dim=-1) > 0
        lab = torch.where(scribbled, pos_scr.argmax(dim=-1), lab)
        ref_onehot = F.one_hot(lab.reshape(-1), o).float() * obj_valid
        ref_emb = emb[annot].reshape(-1, emb.shape[-1])
        return int_probs, int_mem, gmap_mem, ref_emb, ref_onehot

    def _start_impl(self, state: SequenceState, raster, annot: int,
                    obj_valid, stack: tuple[int, int] | None) -> dict:
        """The round head: interaction branch, the matching reference (in
        stacked mode this round's slot of the memory, written in place,
        and the live rows), the round-constant conv0 contributions of the
        decomposed head, and the bucketed reference (not in cp mode: each
        member buckets its own shard per matching call)."""
        model = self.model
        int_probs, int_mem, gmap_mem, ref_emb, ref_onehot = \
            self._interaction(state.feat, state.emb, raster, annot,
                              state.prev_masks, state.gmap_mem,
                              state.int_mem, state.round_idx == 0, obj_valid)
        if stack is not None:
            # match against every stored round: rows of later slots are
            # zero-onehot, and only the live slots are matched
            slot, live_rows = stack
            nq = ref_emb.shape[0]
            rows = slice(slot * nq, (slot + 1) * nq)
            state.mem_emb[rows] = ref_emb.to(state.mem_emb.dtype)
            state.mem_onehot[rows] = ref_onehot
            ref_emb = state.mem_emb[:live_rows]
            ref_onehot = state.mem_onehot[:live_rows]
        return dict(
            int_probs=int_probs, int_mem=int_mem, gmap_mem=gmap_mem,
            obj_valid=obj_valid,
            ref_emb=ref_emb, ref_onehot=ref_onehot,
            head_fp=model.head_feat_contrib(state.feat),
            head_mp=model.head_mem_contrib(int_mem),
            bucketed=(model.prepare_ref(ref_emb, ref_onehot)
                      if self.cp_mesh is None else None))

    def _sweep_impl(self, state: SequenceState, head: dict, annot: int,
                    carry, probs, gmap, frame_valid, *, start: int,
                    count: int):
        """Propagate steps [start, start + count) of the round's (T-1)-step
        schedule, writing into probs / gmap (the round's copies) in place.
        Step i visits frame annot+1+i on the forward sweep, then annot-1-..
        backward; the carry resets to the interaction output where the
        backward sweep starts, so any split of the schedule computes the
        monolithic round's masks. -> (carry, frames visited)."""
        model, feat, emb = self.model, state.feat, state.emb
        t, h, w, ce = emb.shape
        o = probs.shape[-1]
        idx = start + np.arange(count)
        fwd_len = t - 1 - annot
        frame = np.where(idx < fwd_len, annot + 1 + idx,
                         annot - 1 - (idx - fwd_len))
        prev_frame = np.where(idx < fwd_len, frame - 1, frame + 1)
        frame_t = torch.as_tensor(frame, device=emb.device)
        # global matching does not depend on the carry: all the span's
        # frames in one matching call (one launch; cp: one per member)
        query = emb[frame_t].reshape(-1, ce)
        if self.cp_mesh is not None:
            gm_pre = cp_match_flat(query, head["ref_emb"], head["ref_onehot"],
                                   self.cp_mesh)
        else:
            gm_pre = model.match_prepared(query, head["bucketed"])
        gm_pre = gm_pre.reshape(count, h, w, o)
        ref_emb, ref_onehot = head["ref_emb"], head["ref_onehot"]
        int_probs, int_mem = head["int_probs"], head["int_mem"]
        probs_seq, g_seq = [], []
        for j in range(count):
            f = int(frame[j])
            prev = int_probs if idx[j] == fwd_len else carry
            logits, g_new = model.propagate(
                feat[f], emb[f], ref_emb, ref_onehot, None, gmap[f],
                emb[int(prev_frame[j])], prev, int_mem, head["obj_valid"],
                gmap_override=gm_pre[j],
                head_pre=head["head_fp"][f][None] + head["head_mp"])
            carry = torch.softmax(logits, dim=-1)
            probs_seq.append(carry)
            g_seq.append(g_new)
        # padding frames keep their state
        fv = frame_valid[frame_t][:, None, None, None]
        probs[frame_t] = torch.where(fv, torch.stack(probs_seq),
                                     probs[frame_t])
        gmap[frame_t] = torch.where(fv, torch.stack(g_seq), gmap[frame_t])
        return carry, frame_t

    def _segment_spans(self, t: int) -> list[tuple[int, int]]:
        """Split the (t-1)-step schedule into round_segments spans that
        grow about 2x each: the first segment's masks start downloading
        early and the larger later ones compute under the earlier
        downloads. The last span is the largest."""
        n = t - 1
        if n == 0:
            return []
        s = min(self.cfg.eval.round_segments, n)
        total = (1 << s) - 1
        spans, pos, cum = [], 0, 0
        for i in range(s):
            cum += 1 << i
            end = n if i == s - 1 else min(
                max(round(n * cum / total), pos + 1),  # >= 1 per span
                n - (s - 1 - i))                       # >= 1 per later span
            spans.append((pos, end - pos))
            pos = end
        return spans

    def _masks_impl(self, probs, *, hw, pack):
        """(T, h, w, O) -> (T, H, W * pack / 8) bit-packed argmax labels."""
        lab = resize_bilinear(probs, hw).argmax(dim=-1).to(torch.uint8)
        return pack_labels(lab, pack)

    # ---------------- host orchestration ------------------------------- #

    def object_bucket(self, num_objects: int | None) -> int:
        return object_bucket_for(num_objects, self.o)

    def frame_bucket(self, num_frames: int) -> int:
        """The smallest enabled frame bucket that fits the sequence."""
        cfg = self.cfg
        for b in sorted(set(cfg.eval.frame_buckets) | {cfg.eval.max_frames}):
            if num_frames <= b <= cfg.eval.max_frames:
                return b
        raise ValueError(
            f"sequence has {num_frames} frames > eval.max_frames="
            f"{cfg.eval.max_frames}; raise max_frames (and ensure a frame "
            "bucket covers it)")

    @torch.inference_mode()
    def start_sequence(self, images: np.ndarray,
                       num_objects: int | None = None) -> SequenceState:
        """Extract features of all frames (the once-per-video cost) in
        8-frame chunks over the padded frame bucket; init memories.

        `images` (T, H, W, 3): host-normalized floats, or raw uint8 RGB
        that is normalized on the device. Padding is the mean pixel either
        way: 0.0 for floats, the mean byte for uint8 (a zero byte would be
        black, about -2 sigma, and bleed into the edge features)."""
        t_actual = images.shape[0]
        t_pad = self.frame_bucket(t_actual)
        dt = np.uint8 if images.dtype == np.uint8 else np.float32
        h0, w0 = images.shape[1:3]
        images = pad_image_to(images.astype(dt, copy=False),
                              self.cfg.eval.pad_to)
        if dt == np.uint8 and images.shape[1:3] != (h0, w0):
            images[:, h0:] = _MEAN_U8          # a padded copy: safe to write
            images[:, :, w0:] = _MEAN_U8
        if t_actual < t_pad:
            fill = _MEAN_U8 if dt == np.uint8 else 0
            images = np.concatenate(
                [images, np.full((t_pad - t_actual, *images.shape[1:]), fill,
                                 dt)])
        chunk = min(8, t_pad)
        if t_pad % chunk:
            raise ValueError(f"frame bucket {t_pad} is not a multiple of the "
                             f"{chunk}-frame encoder chunk")
        feats, embs = [], []
        for i in range(0, t_pad, chunk):
            x = torch.from_numpy(np.ascontiguousarray(images[i:i + chunk]))
            x = x.to(self.device)
            if dt == np.uint8:
                x = preprocess_frames(x)
            f, e = self.model.extract_features(x)
            feats.append(f)
            embs.append(e)
        feat = torch.cat(feats).contiguous()
        emb = torch.cat(embs).contiguous()
        return self._init_state(feat, emb, t_actual, num_objects)

    def _init_state(self, feat, emb, t_actual: int,
                    num_objects: int | None) -> SequenceState:
        o = self.object_bucket(num_objects)
        t, h, w = feat.shape[:3]
        dev = feat.device
        prev = torch.zeros((t, h, w, o), dtype=torch.float32, device=dev)
        prev[..., 0] = 1.0
        mem_emb = mem_onehot = None
        if self.memory_mode == "stacked":
            m = self.cfg.eval.max_interactions * h * w
            mem_emb = torch.zeros((m, emb.shape[-1]), dtype=emb.dtype,
                                  device=dev)
            mem_onehot = torch.zeros((m, o), dtype=torch.float32, device=dev)
        return SequenceState(
            feat=feat, emb=emb, prev_masks=prev,
            gmap_mem=torch.ones((t, h, w, o), dtype=torch.float32, device=dev),
            int_mem=torch.zeros((o, h, w, self.cfg.model.ma_channels),
                                dtype=torch.float32, device=dev),
            round_idx=0, num_frames=t_actual,
            mem_emb=mem_emb, mem_onehot=mem_onehot)

    def reset_rounds(self, state: SequenceState,
                     num_objects: int | None = None) -> SequenceState:
        """New-item state reusing the sequence's cached features."""
        release_state(state, keep_features=True)
        return self._init_state(state.feat, state.emb, state.num_frames,
                                num_objects)

    def run_round(self, state: SequenceState, scribbles_json: Dict[str, Any],
                  image_hw: tuple[int, int], num_objects: int) -> np.ndarray:
        """One interaction round. Returns (T_actual, H, W) int32 labels."""
        cfg = self.cfg
        t0 = time.perf_counter()
        af = annotated_frames(scribbles_json)
        annot = af[0] if af else 0
        one_frame = {"sequence": scribbles_json["sequence"],
                     "scribbles": [scribbles_json["scribbles"][annot]]}
        raster = scribbles2mask(one_frame, image_hw)[0]
        raster = np.pad(raster,
                        [(0, (-image_hw[0]) % cfg.eval.pad_to),
                         (0, (-image_hw[1]) % cfg.eval.pad_to)],
                        constant_values=-1)
        handle = self.dispatch_round(state, raster, annot, num_objects)
        masks = self.collect_round(handle, image_hw)
        dt = time.perf_counter() - t0
        self.round_latencies.append(dt)
        self.round_records.append(
            (handle.t_bucket, state.prev_masks.shape[-1], dt))
        return masks

    @torch.inference_mode()
    def dispatch_round(self, state: SequenceState, raster: np.ndarray,
                       annot: int, num_objects: int) -> RoundHandle:
        """Enqueue one round's device work, updating `state` in place.
        `raster` is the annotated frame's scribble raster padded to
        `pad_to` (-1 = unscribbled). With round_segments > 1 the sweep
        runs in segments, and each segment's packed masks go to the
        download pool while the next segment computes; the monolithic
        round packs all frames at its end, for `collect_round`."""
        cfg = self.cfg
        dev = self.device
        o_bucket = state.prev_masks.shape[-1]
        if num_objects + 1 > o_bucket:
            raise ValueError(f"{num_objects} objects do not fit the object "
                             f"bucket {o_bucket} (background included)")
        obj_valid = torch.zeros((o_bucket,), dtype=torch.float32, device=dev)
        obj_valid[:num_objects + 1] = 1.0
        t_bucket = state.feat.shape[0]
        frame_valid = torch.arange(t_bucket, device=dev) < state.num_frames
        ms = cfg.eval.mask_stride
        mask_hw = (raster.shape[0] // ms, raster.shape[1] // ms)
        pk = aligned_mask_bits(num_objects + 1, mask_hw[1])
        raster_t = torch.as_tensor(np.asarray(raster, np.int8), device=dev)
        stack = None
        if self.memory_mode == "stacked":
            cap = cfg.eval.max_interactions
            slot = min(state.round_idx, cap - 1)   # past capacity: the last
            h, w = state.feat.shape[1:3]
            stack = (slot, live_page_bucket(slot + 1, cap) * h * w)
        annot = int(annot)
        head = self._start_impl(state, raster_t, annot, obj_valid, stack)
        # the round's copies of the per-frame state; the annotated frame
        # keeps the interaction-branch result
        probs = state.prev_masks.clone()
        probs[annot] = head["int_probs"]
        gmap = head["gmap_mem"].clone()
        carry = head["int_probs"]
        handle = RoundHandle(pk=pk, annot=annot, nf=state.num_frames,
                             t_bucket=t_bucket)
        if cfg.eval.round_segments > 1:
            handle.annot_mask = _FETCH_POOL.submit(
                _download, self._masks_impl(head["int_probs"][None],
                                            hw=mask_hw, pack=pk))
            handle.seg_masks = []
            for s0, c in self._segment_spans(t_bucket):
                carry, frames = self._sweep_impl(
                    state, head, annot, carry, probs, gmap, frame_valid,
                    start=s0, count=c)
                mk = self._masks_impl(probs[frames], hw=mask_hw, pack=pk)
                handle.seg_masks.append(
                    (s0, c, _FETCH_POOL.submit(_download, mk)))
        else:
            if t_bucket > 1:
                self._sweep_impl(state, head, annot, carry, probs, gmap,
                                 frame_valid, start=0, count=t_bucket - 1)
            handle.masks = self._masks_impl(probs, hw=mask_hw, pack=pk)
        state.prev_masks, state.gmap_mem = probs, gmap
        state.int_mem = head["int_mem"]
        state.round_idx += 1
        return handle

    def collect_round(self, handle: RoundHandle,
                      image_hw: tuple[int, int]) -> np.ndarray:
        """Download (monolithic) or gather (segmented) a dispatched
        round's (T_actual, H, W) labels."""
        pk = handle.pk
        if handle.masks is not None:
            masks = unpack_labels(_download(handle.masks[:handle.nf]), pk)
        else:
            lab_annot = unpack_labels(handle.annot_mask.result(), pk)[0]
            nf = handle.nf
            masks = np.zeros((nf, *lab_annot.shape), np.uint8)
            masks[handle.annot] = lab_annot
            fwd_len = handle.t_bucket - 1 - handle.annot
            for s0, c, fut in handle.seg_masks:
                lab = unpack_labels(fut.result(), pk)
                for j in range(c):
                    i = s0 + j
                    f = (handle.annot + 1 + i if i < fwd_len
                         else handle.annot - 1 - (i - fwd_len))
                    if f < nf:
                        masks[f] = lab[j]
        ms = self.cfg.eval.mask_stride
        if ms > 1:
            masks = np.repeat(np.repeat(masks, ms, axis=1), ms, axis=2)
        h_img, w_img = image_hw
        return masks[:, :h_img, :w_img].astype(np.int32)

    # ---------------- full benchmark ----------------------------------- #

    def run_session(self, session, on_masks=None) -> Dict[str, Any]:
        """Drive an InteractiveSession to completion (SURVEY.md §4.1).
        One live sequence state; features are reused across a sequence's
        scribble sets, so the encoder runs once per video.

        on_masks(seq, set_idx, round_idx, masks): optional per-submission
        callback."""
        st: SequenceState | None = None
        st_key = None          # (sequence, set) the live state serves
        st_seq = None          # sequence whose features st holds
        hw = None              # full-res (H, W) of st_seq
        with session as sess:
            while sess.next():
                seq, scribbles, _ = sess.get_scribbles(only_last=True)
                key = sess.current
                if key != st_key:
                    if seq == st_seq:
                        st = self.reset_rounds(
                            st, sess.dataset.num_objects(seq))
                    else:
                        if st is not None:
                            release_state(st)
                        # raw uint8 frames when the dataset has them: a
                        # quarter of the bytes, normalized on the device
                        images_fn = getattr(sess.dataset, "images_uint8",
                                            sess.dataset.images)
                        images = images_fn(seq)
                        hw = images.shape[1:3]
                        st = self.start_sequence(
                            images, sess.dataset.num_objects(seq))
                        st_seq = seq
                    st_key = key
                masks = self.run_round(
                    st, scribbles, hw, sess.dataset.num_objects(seq))
                if on_masks is not None:
                    on_masks(seq, key[1], st.round_idx - 1, masks)
                sess.submit_masks(masks)
        if st is not None:
            release_state(st)
        return session.get_global_summary()
