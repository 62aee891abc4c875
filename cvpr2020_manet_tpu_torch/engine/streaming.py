"""Streaming interactive VOS serving (1080p, memory that grows with the
corrections), PyTorch port of `engine/streaming.py`.

Frames arrive one at a time; there is no cache of a whole video:

    s = StreamingIVOS(cfg, model)          # cuda unless device= is given
    s.reset(num_objects)
    mask = s.observe(frame)                # segment the newest frame
    fut = s.observe_async(frame)           # the same, the mask as a Future
    mask = s.correct(scribbles_json)       # the user corrects that frame

State kept on the device between calls:
- the matching memory: the annotated frame's pixels of every correction,
  in `max_interactions` pages of (H/4)(W/4) rows; each frame matches the
  live pages only (`live_pages`: the filled count rounded up to a power
  of 2), one global-matching launch per frame;
- the MA interaction memory and its conv0 contribution to the head, which
  change only on `correct`;
- the previous frame's embedding and probabilities, for local matching.

`observe_async` enqueues the upload and the device work and hands the
packed mask's download to the shared download pool, so that frame i's
mask crosses the link while frame i+1 computes; `observe` waits for it.
Masks are bit-packed at the live label count (`engine/labels.py`). A
frame takes raw uint8 RGB (normalized on the device), host-normalized
floats, or a planar YUV 4:2:0 (y, uv) pair, sent as one flat buffer.
Phase spans (`utils/profiling.annotate`): `manet.observe` =
`manet.observe.ingest` (host padding and the upload) +
`manet.observe.dispatch` (the device work enqueued, the state updated) +
`manet.observe.wait` (the mask's download and unpack on the pool, which
no span there can see).

The memory is f32, as in JAX. With the default matching backend a bf16
query meets it in f32 (kernel 1's f32 variant); with
`matching_backend="int8"` both are quantized to int8 (kernel 3).

With a `cp_mesh` (`parallel/mesh.py`) the live pages shard over the mesh's
context members: each member matches its rows (kernel 1 on a card, one
launch per member and observe), the results meet in a min
(`parallel/cp_matching.py`, the allgather schedule), and the map goes to
the propagation head as its global matching. The int8 backend has no
context-parallel fold and raises, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.config import Config, check_params_only
from cvpr2020_manet_tpu_torch.device import resolve_device
from cvpr2020_manet_tpu_torch.engine.evaluator import (
    downsample_mask_max, live_page_bucket, object_bucket_for, pad_image_to)
from cvpr2020_manet_tpu_torch.engine.labels import (
    FETCH_POOL, aligned_mask_bits, download, pack_labels, unpack_labels)
from cvpr2020_manet_tpu_torch.interactive.scribbles import (
    annotated_frames, scribble_masks_per_object, scribbles2mask)
from cvpr2020_manet_tpu_torch.models.layers import resize_bilinear
from cvpr2020_manet_tpu_torch.models.manet import NEG_INF, MANet
from cvpr2020_manet_tpu_torch.parallel.cp_matching import (
    check_cp_engine, cp_match_flat)
from cvpr2020_manet_tpu_torch.utils.ingest import (
    preprocess_frames, preprocess_yuv420)
from cvpr2020_manet_tpu_torch.utils.profiling import annotate


class StreamingIVOS:
    def __init__(self, cfg: Config, model: MANet, device=None,
                 cp_mesh=None):
        """`cp_mesh`: a `parallel.mesh.Mesh` over which the live memory
        pages shard (context-parallel matching)."""
        check_params_only(model.cfg, "StreamingIVOS")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cp_mesh = cp_mesh
        if cp_mesh is not None:
            check_cp_engine(cp_mesh, self.device, model.matching_backend,
                            "streaming")
        self.o = cfg.model.max_objects + 1
        self.stride = cfg.model.feature_stride
        h, w = cfg.eval.image_size
        self.hp = h + (-h) % cfg.eval.pad_to
        self.wp = w + (-w) % cfg.eval.pad_to
        # state grids at the decoder's output stride
        self.hh, self.ww = self.hp // self.stride, self.wp // self.stride
        self.capacity = cfg.eval.max_interactions
        self.state = None

    # ------------------------------------------------------------------ #

    def reset(self, num_objects: int) -> None:
        """A new stream of `num_objects` objects (the object bucket follows
        the evaluator's policy, the mask bit depth `aligned_mask_bits`)."""
        if not 0 < num_objects <= self.cfg.model.max_objects:
            # an over-budget stream would drop the extra objects'
            # scribbles from the positive channels but count them as
            # negatives
            raise ValueError(
                f"num_objects={num_objects} outside 1..="
                f"{self.cfg.model.max_objects} (ModelConfig.max_objects)")
        mcfg, dev = self.cfg.model, self.device
        hh, ww = self.hh, self.ww
        o = object_bucket_for(num_objects, self.o)
        self._o_bucket = o
        self._bits = aligned_mask_bits(num_objects + 1, self.wp)
        m = self.capacity * hh * ww
        obj_valid = torch.zeros((o,), dtype=torch.float32, device=dev)
        obj_valid[:num_objects + 1] = 1.0
        prev_probs = torch.zeros((hh, ww, o), dtype=torch.float32, device=dev)
        prev_probs[..., 0] = 1.0
        self.state = dict(
            mem_emb=torch.zeros((m, mcfg.embedding_dim_padded),
                                dtype=torch.float32, device=dev),
            mem_onehot=torch.zeros((m, o), dtype=torch.float32, device=dev),
            rounds=0,
            int_mem=torch.zeros((o, hh, ww, mcfg.ma_channels),
                                dtype=torch.float32, device=dev),
            prev_emb=torch.zeros((hh, ww, mcfg.embedding_dim_padded),
                                 dtype=torch.float32, device=dev),
            prev_probs=prev_probs,
            cur_feat=None, cur_emb=None, cur_probs=None,
            obj_valid=obj_valid,
            # the MA memory's conv0 contribution to the propagation head;
            # that of the zero memory is zero (conv0 has no bias)
            head_mem_pre=torch.zeros((o, hh, ww, mcfg.head_channels),
                                     dtype=self.model.dtype, device=dev),
        )

    # ------------------------------------------------------------------ #

    def _zero_padded_border(self, image: torch.Tensor) -> torch.Tensor:
        """Zero (the ImageNet mean) the padded border after normalization,
        so that every ingest path gives the encoder the same padding."""
        h_img, w_img = self.cfg.eval.image_size
        image[h_img:] = 0.0
        image[:, w_img:] = 0.0
        return image

    def _frame(self, image: torch.Tensor) -> torch.Tensor:
        """An uploaded frame -> normalized f32 (hp, wp, 3)."""
        if image.ndim == 1:
            # planar YUV 4:2:0 in one flat buffer: the y plane, then uv
            hp, wp = self.hp, self.wp
            y = image[:hp * wp].reshape(hp, wp)
            uv = image[hp * wp:].reshape(hp // 2, wp // 2, 2)
            return self._zero_padded_border(preprocess_yuv420(y, uv))
        if image.dtype == torch.uint8:
            return self._zero_padded_border(preprocess_frames(image))
        return image

    @torch.inference_mode()
    def _observe(self, image: torch.Tensor, n_rows: int, bits: int):
        model, st = self.model, self.state
        # the matching memory restricted to the live pages (pages fill in
        # round order, so the live rows are a prefix)
        mem_emb = st["mem_emb"][:n_rows]
        mem_onehot = st["mem_onehot"][:n_rows]
        o = mem_onehot.shape[-1]
        feat, emb = model.extract_features(self._frame(image)[None])
        f_t, e_t = feat[0], emb[0]
        head_fp = model.head_feat_contrib(feat)
        gmap_override = None
        if self.cp_mesh is not None:
            gmap_override = cp_match_flat(
                e_t.reshape(-1, e_t.shape[-1]), mem_emb, mem_onehot,
                self.cp_mesh).reshape(self.hh, self.ww, o)
        logits, _ = model.propagate(
            f_t, e_t, mem_emb, mem_onehot, None,
            torch.ones((self.hh, self.ww, o), dtype=torch.float32,
                       device=self.device),
            st["prev_emb"], st["prev_probs"], st["int_mem"], st["obj_valid"],
            gmap_override=gmap_override,
            head_pre=head_fp + st["head_mem_pre"])
        probs = torch.softmax(logits, dim=-1)
        if st["rounds"] == 0:
            # before any correction there is no memory: all background
            probs = torch.zeros_like(probs)
            probs[..., 0] = 1.0
        return f_t, e_t, probs, self._mask(probs, bits)

    @torch.inference_mode()
    def _correct(self, pos, neg, round_idx: int, is_first: bool, bits: int):
        model, st = self.model, self.state
        mem_emb, mem_onehot = st["mem_emb"], st["mem_onehot"]
        o = mem_onehot.shape[-1]
        obj_valid = st["obj_valid"]
        int_feats, int_logits = model.interact(st["cur_feat"], pos, neg,
                                               st["cur_probs"])
        int_mem = model.aggregate_memory(int_feats, st["int_mem"], is_first)
        probs = torch.softmax(int_logits + (1.0 - obj_valid) * NEG_INF, dim=-1)
        lab = probs.argmax(dim=-1)
        scribbled = pos.amax(dim=-1) > 0
        lab = torch.where(scribbled, pos.argmax(dim=-1), lab)
        onehot = F.one_hot(lab.reshape(-1), o).float() * obj_valid
        ref = st["cur_emb"].reshape(-1, st["cur_emb"].shape[-1])
        # the page of this correction, written in place
        off = round_idx * ref.shape[0]
        mem_emb[off:off + ref.shape[0]] = ref.to(mem_emb.dtype)
        mem_onehot[off:off + ref.shape[0]] = onehot
        return probs, int_mem, self._mask(probs, bits), \
            model.head_mem_contrib(int_mem)

    def _mask(self, probs: torch.Tensor, bits: int) -> torch.Tensor:
        """Full-resolution argmax labels, bit-packed at `bits` per pixel."""
        up = resize_bilinear(probs, (self.hp, self.wp))
        return pack_labels(up.argmax(dim=-1).to(torch.uint8), bits)

    def _unpack(self, packed: torch.Tensor, bits: int) -> np.ndarray:
        # `bits` is bound when the frame is dispatched: a reset() that
        # changes the stream's bit depth must not reinterpret masks in
        # flight
        h, w = self.cfg.eval.image_size
        lab = unpack_labels(download(packed), bits)
        return lab[:h, :w].astype(np.int32)

    # ------------------------------------------------------------------ #

    def observe_async(self, image):
        """Segment a new frame; -> a Future of its (H, W) int32 labels.

        image: (H, W, 3) uint8 raw RGB (normalized on the device), float32
        already ImageNet-normalized, or a planar YUV 4:2:0 (y (H, W), uv
        (H/2, W/2, 2)) uint8 pair, the video decoder's output."""
        if self.state is None:
            raise RuntimeError("call reset(num_objects) first")
        st = self.state
        with annotate("manet.observe.ingest"):
            image = self._upload(image)
        with annotate("manet.observe.dispatch"):
            f_t, e_t, probs, mask = self._observe(
                image, self.live_pages() * self.hh * self.ww, self._bits)
            st["prev_emb"], st["prev_probs"] = e_t, probs
            st["cur_feat"], st["cur_emb"], st["cur_probs"] = f_t, e_t, probs
            return FETCH_POOL.submit(self._unpack, mask, self._bits)

    def _upload(self, image) -> torch.Tensor:
        """A frame padded on the host and copied to the device in one
        buffer."""
        pad_to = self.cfg.eval.pad_to
        if isinstance(image, tuple):
            y, uv = image
            y = pad_image_to(y[..., None], pad_to)[..., 0]
            uv = pad_image_to(uv, pad_to // 2)
            # one flat buffer: one host-to-device copy
            image = np.concatenate([np.ascontiguousarray(y).reshape(-1),
                                    np.ascontiguousarray(uv).reshape(-1)])
        else:
            if image.dtype != np.uint8:
                image = image.astype(np.float32)
            image = np.ascontiguousarray(pad_image_to(image, pad_to))
        return torch.from_numpy(image).to(self.device)

    def observe(self, image) -> np.ndarray:
        """`observe_async` and wait: the same masks, serial timing."""
        with annotate("manet.observe"):
            fut = self.observe_async(image)
            with annotate("manet.observe.wait"):
                return fut.result()

    def live_pages(self) -> int:
        """Memory pages the next frame matches (a power-of-2 bucket of the
        filled pages, at least 1)."""
        return live_page_bucket(self.state["rounds"], self.capacity)

    def correct(self, scribbles_json) -> np.ndarray:
        """The user's scribbles on the newest frame -> its refreshed mask;
        the frame's pixels become a new memory page (past `capacity`
        corrections, the last page is overwritten)."""
        st = self.state
        if st is None or st["cur_feat"] is None:
            raise RuntimeError("observe() a frame first")
        h, w = self.cfg.eval.image_size
        pad_to = self.cfg.eval.pad_to
        af = annotated_frames(scribbles_json)
        raster = scribbles2mask(scribbles_json, (h, w))[af[0] if af else 0]
        pos, neg = scribble_masks_per_object(raster, self._o_bucket - 1)
        pos, neg = (torch.from_numpy(downsample_mask_max(
            pad_image_to(x, pad_to), self.stride)).to(self.device)
            for x in (pos, neg))
        r = min(st["rounds"], self.capacity - 1)
        probs, int_mem, mask, head_mem_pre = self._correct(
            pos, neg, r, st["rounds"] == 0, self._bits)
        st.update(int_mem=int_mem, cur_probs=probs, prev_probs=probs,
                  head_mem_pre=head_mem_pre)
        st["rounds"] += 1
        return self._unpack(mask, self._bits)
