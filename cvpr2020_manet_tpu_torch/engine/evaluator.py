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
   propagation head and a softmax. On a CUDA device each step replays a
   CUDA graph captured once per step shape (`engine/round_graph.py`);
   elsewhere the step runs as it is;
4. probabilities are upsampled and argmaxed (`_labels_impl`), and every
   frame's labels stay on the device at the round's end; `collect_round`
   crops them to the real frames and the image, repeats them by
   `mask_stride` and casts them to int32 there, then downloads them into
   pinned host memory (`engine/labels.py`: `crop_labels`, `to_host`; on a
   CPU evaluator they are already on the host).

The round is this one path: `EvalConfig.round_segments` (JAX's segmented
round, which hid a TPU's slow device-to-host link) must be 1.

Frames come as host-normalized floats or as raw uint8 RGB, which is
padded with the ImageNet mean byte and normalized on the device.

Everything runs under `torch.inference_mode()` on the evaluator's device
(`cuda` unless the caller passes another).

Phase spans (`utils/profiling.annotate`; recorded only while a profiler
runs on the calling thread) cover each call end to end:
`manet.start_sequence` = `manet.start.pad` (host padding) +
`manet.start.encode` (upload, encoder, initial state); `manet.round` =
`manet.round.rasterize` (scribbles to a padded raster) +
`manet.round.dispatch` (all of `dispatch_round`; inside it a
`manet.round.step` span a sweep step, and a `manet.round.replay` span in
each replayed one) + `manet.round.wait` (the masks' crop and download) +
`manet.round.unpack` (the host's share: the numpy view of the downloaded
labels).

The bucket policies the stream follows live here too: the object and
live-page buckets, the spatial padding and the scribbles' max-pool.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.config import Config, check_params_only
from cvpr2020_manet_tpu_torch.data.davis import IMAGENET_MEAN
from cvpr2020_manet_tpu_torch.device import resolve_device
from cvpr2020_manet_tpu_torch.engine.labels import crop_labels, to_host
from cvpr2020_manet_tpu_torch.engine.round_graph import SweepSteps
from cvpr2020_manet_tpu_torch.interactive.scribbles import (
    annotated_frames, scribbles2mask)
from cvpr2020_manet_tpu_torch.models.layers import resize_bilinear
from cvpr2020_manet_tpu_torch.models.manet import NEG_INF, MANet
from cvpr2020_manet_tpu_torch.parallel.cp_matching import (
    check_cp_engine, cp_match_flat)
from cvpr2020_manet_tpu_torch.utils.ingest import preprocess_frames
from cvpr2020_manet_tpu_torch.utils.profiling import annotate

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


def object_bucket_for(num_objects: int | None, o_max: int) -> int:
    """Padded object-axis size for a sequence (4 when it fits, else the
    full bucket)."""
    if num_objects is None:
        return o_max
    for b in sorted({min(4, o_max), o_max}):
        if num_objects + 1 <= b:
            return b
    return o_max


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


@dataclasses.dataclass
class RoundHandle:
    """Device outputs of one dispatched round, not yet downloaded."""
    nf: int                 # actual (unpadded) frame count
    t_bucket: int
    # (T, H_pad / mask_stride, W_pad / mask_stride) int64 argmax labels of
    # every frame of the bucket, on the device
    masks: torch.Tensor


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
        if cfg.eval.round_segments != 1:
            raise ValueError(
                f"round_segments={cfg.eval.round_segments!r}: the Evaluator "
                "runs the monolithic round only (round_segments=1); JAX's "
                "segmented round hides a slow device-to-host link, which "
                "the card's is not")
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
        self._steps = SweepSteps(self.model)
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
                    probs, gmap, frame_valid) -> None:
        """Propagate the round's (T-1)-step schedule, writing into probs /
        gmap (the round's copies) in place: frames annot+1 .. T-1 forward,
        then annot-1 .. 0 backward, the carry reset to the interaction
        output where the backward sweep starts."""
        model, feat, emb = self.model, state.feat, state.emb
        t, h, w, ce = emb.shape
        o = probs.shape[-1]
        fwd_len = t - 1 - annot
        frame = np.concatenate([np.arange(annot + 1, t),
                                np.arange(annot - 1, -1, -1)])
        prev_frame = np.where(np.arange(t - 1) < fwd_len, frame - 1,
                              frame + 1)
        frame_t = torch.as_tensor(frame, device=emb.device)
        # global matching does not depend on the carry: every frame in one
        # matching call (one launch; cp: one per member)
        query = emb[frame_t].reshape(-1, ce)
        if self.cp_mesh is not None:
            gm_pre = cp_match_flat(query, head["ref_emb"], head["ref_onehot"],
                                   self.cp_mesh)
        else:
            gm_pre = model.match_prepared(query, head["bucketed"])
        gm_pre = gm_pre.reshape(t - 1, h, w, o)
        probs_seq, g_seq = self._steps.run(feat, emb, gmap, gm_pre, head,
                                           frame, prev_frame, fwd_len)
        # padding frames keep their state
        fv = frame_valid[frame_t][:, None, None, None]
        probs[frame_t] = torch.where(fv, probs_seq, probs[frame_t])
        gmap[frame_t] = torch.where(fv, g_seq, gmap[frame_t])

    @staticmethod
    def _labels_impl(probs, *, hw):
        """(T, h, w, O) -> (T, H, W) int64 argmax labels at `hw`."""
        return resize_bilinear(probs, hw).argmax(dim=-1)

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
        with annotate("manet.start_sequence"):
            t_actual = images.shape[0]
            t_pad = self.frame_bucket(t_actual)
            with annotate("manet.start.pad"):
                images = self._pad_frames(images, t_pad)
            with annotate("manet.start.encode"):
                return self._encode(images, t_actual, num_objects)

    def _pad_frames(self, images: np.ndarray, t_pad: int) -> np.ndarray:
        """(T, H, W, 3) -> (t_pad, H_pad, W_pad, 3) on the host, padded
        with the mean pixel."""
        t_actual = images.shape[0]
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
        return images

    def _encode(self, images: np.ndarray, t_actual: int,
                num_objects: int | None) -> SequenceState:
        """The padded frames' features, uploaded and encoded in 8-frame
        chunks, and the sequence's initial state."""
        t_pad = images.shape[0]
        chunk = min(8, t_pad)
        if t_pad % chunk:
            raise ValueError(f"frame bucket {t_pad} is not a multiple of the "
                             f"{chunk}-frame encoder chunk")
        feats, embs = [], []
        for i in range(0, t_pad, chunk):
            x = torch.from_numpy(np.ascontiguousarray(images[i:i + chunk]))
            x = x.to(self.device)
            if images.dtype == np.uint8:
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
        pad_to = self.cfg.eval.pad_to
        t0 = time.perf_counter()
        with annotate("manet.round"):
            with annotate("manet.round.rasterize"):
                af = annotated_frames(scribbles_json)
                annot = af[0] if af else 0
                one_frame = {"sequence": scribbles_json["sequence"],
                             "scribbles": [scribbles_json["scribbles"][annot]]}
                raster = scribbles2mask(one_frame, image_hw)[0]
                raster = np.pad(raster,
                                [(0, (-image_hw[0]) % pad_to),
                                 (0, (-image_hw[1]) % pad_to)],
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
        `pad_to` (-1 = unscribbled). The round argmaxes all frames at its
        end and keeps the labels on the device, for `collect_round`."""
        with annotate("manet.round.dispatch"):
            cfg = self.cfg
            dev = self.device
            o_bucket = state.prev_masks.shape[-1]
            if num_objects + 1 > o_bucket:
                raise ValueError(f"{num_objects} objects do not fit the "
                                 f"object bucket {o_bucket} (background "
                                 "included)")
            obj_valid = torch.zeros((o_bucket,), dtype=torch.float32,
                                    device=dev)
            obj_valid[:num_objects + 1] = 1.0
            t_bucket = state.feat.shape[0]
            frame_valid = torch.arange(t_bucket, device=dev) < state.num_frames
            ms = cfg.eval.mask_stride
            mask_hw = (raster.shape[0] // ms, raster.shape[1] // ms)
            raster_t = torch.as_tensor(np.asarray(raster, np.int8), device=dev)
            stack = None
            if self.memory_mode == "stacked":
                cap = cfg.eval.max_interactions
                # past capacity: the last slot
                slot = min(state.round_idx, cap - 1)
                h, w = state.feat.shape[1:3]
                stack = (slot, live_page_bucket(slot + 1, cap) * h * w)
            annot = int(annot)
            head = self._start_impl(state, raster_t, annot, obj_valid, stack)
            # the round's copies of the per-frame state; the annotated frame
            # keeps the interaction-branch result
            probs = state.prev_masks.clone()
            probs[annot] = head["int_probs"]
            gmap = head["gmap_mem"].clone()
            if t_bucket > 1:
                self._sweep_impl(state, head, annot, probs, gmap, frame_valid)
            handle = RoundHandle(nf=state.num_frames, t_bucket=t_bucket,
                                 masks=self._labels_impl(probs, hw=mask_hw))
            state.prev_masks, state.gmap_mem = probs, gmap
            state.int_mem = head["int_mem"]
            state.round_idx += 1
            return handle

    def collect_round(self, handle: RoundHandle,
                      image_hw: tuple[int, int]) -> np.ndarray:
        """Crop, cast and download a dispatched round's (T_actual, H, W)
        int32 labels."""
        with annotate("manet.round.wait"):
            masks = to_host(crop_labels(handle.masks[:handle.nf], image_hw,
                                        self.cfg.eval.mask_stride))
        with annotate("manet.round.unpack"):
            return masks.numpy()

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
