"""Batched multi-sequence mask propagation, PyTorch port of
`engine/propagate_batch.py` (offline propagation at YouTube-VOS scale).

Given B clips and their first-frame object masks, propagate every clip's
masks through time. The host supplies raw frames (uint8 RGB, or planar
YUV 4:2:0 at half the bytes) and receives label maps; normalization,
feature extraction, seeding from the first mask and the temporal sweep run
on the device. Three pieces, which `propagate` composes and a streaming
caller can interleave:

- `upload`: frames cross to the device in 8-frame chunks (plus one
  remainder chunk), each encoded right after its copy, so that a chunk's
  copy overlaps the previous chunk's encoder work; `threads > 1` issues
  the copies from a thread pool;
- `dispatch`: one sequence after another, each in its own object bucket:
  seed the interaction memory from the first mask, then a Python loop of
  `model.propagate` over frames 1 .. T-1 (the matching reference is frame
  0, prepared once per sequence; one global- and one local-matching
  launch per frame), then upsample,
  argmax and bit-pack; each sequence's packed masks go to the download
  pool while the next sequence computes;
- `drain`: wait for the downloads and unpack.

    python -m cvpr2020_manet_tpu_torch.engine.propagate_batch \\
        --batch 4 --frames 16 [--matching_int8] [--ingest yuv420] \\
        [--dataset davis|ytvos --data_root /data/DAVIS]

prints one JSON line (`batched_propagation_fps`). It runs on `cuda`.
"""

from __future__ import annotations

import concurrent.futures
import time

import numpy as np
import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.config import Config, check_params_only
from cvpr2020_manet_tpu_torch.device import resolve_device
from cvpr2020_manet_tpu_torch.engine.evaluator import (
    _FETCH_POOL, bucket_mask_bits, object_bucket_for, pack_labels,
    unpack_labels)
from cvpr2020_manet_tpu_torch.models.layers import resize_bilinear
from cvpr2020_manet_tpu_torch.models.manet import MANet
from cvpr2020_manet_tpu_torch.utils.ingest import (
    preprocess_frames, preprocess_yuv420, rgb_to_yuv420_host)

__all__ = ["BatchPropagator", "preprocess_frames", "timed_batches", "main"]

CHUNK = 8   # frames per encoder call


class BatchPropagator:
    """Propagation of first-frame masks through batches of clips."""

    def __init__(self, cfg: Config, model: MANet, ingest: str = "rgb",
                 device=None):
        if ingest not in ("rgb", "yuv420"):
            raise ValueError(f"unknown ingest format {ingest!r}")
        check_params_only(model.cfg, "BatchPropagator")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.ingest = ingest
        self.o = cfg.model.max_objects + 1
        # (threads, pool), created on the first threaded upload
        self._upload_pool = (0, None)

    @torch.inference_mode()
    def _extract(self, frames):
        """(N, H, W, 3) uint8 RGB, or a (y (N, H, W), uv (N, H/2, W/2, 2))
        uint8 pair under ingest='yuv420', on the device -> (features,
        embeddings)."""
        if self.ingest == "yuv420":
            x = preprocess_yuv420(*frames)
        else:
            x = preprocess_frames(frames)
        return self.model.extract_features(x)

    @torch.inference_mode()
    def _one_seq(self, feat_s, emb_s, first_mask, ov, o: int):
        """One sequence: (T, hh, ww, *) features and embeddings plus the
        first frame's labels (hh, ww) -> bit-packed argmax label maps
        (T, H, W * bits / 8) on the device. `o` is its object bucket."""
        model = self.model
        t, hh, ww, _ = feat_s.shape
        s = self.cfg.model.feature_stride
        first_oh = F.one_hot(first_mask.long(), o).float() * ov
        # seed the interaction memory from the given mask, which stands in
        # for the first round's scribbles
        pos = first_oh
        neg = (pos.amax(dim=-1, keepdim=True) - pos) * ov
        int_feats, _ = model.interact(feat_s[0], pos, neg, first_oh)
        int_mem = model.aggregate_memory(int_feats, torch.zeros_like(int_feats),
                                         True)
        # the matching reference is frame 0 for every step: bucketed (and
        # in int8 quantized) once per sequence
        ce = emb_s.shape[-1]
        bucketed = model.prepare_ref(emb_s[0].reshape(-1, ce),
                                     first_oh.reshape(-1, o))
        # decomposed head stage 1: the per-frame feature and the per-clip
        # memory conv0 contributions, outside the temporal loop
        head_fp = model.head_feat_contrib(feat_s)
        head_mp = model.head_mem_contrib(int_mem)
        no_gmap = torch.ones((hh, ww, o), dtype=torch.float32,
                             device=feat_s.device)
        probs, e_prev = first_oh, emb_s[0]
        probs_seq = [first_oh]
        for i in range(1, t):
            gm = model.match_prepared(emb_s[i].reshape(-1, ce), bucketed)
            logits, _ = model.propagate(
                feat_s[i], emb_s[i], None, None, None, no_gmap, e_prev,
                probs, int_mem, ov, gmap_override=gm.reshape(hh, ww, o),
                head_pre=head_fp[i][None] + head_mp)
            probs, e_prev = torch.softmax(logits, dim=-1), emb_s[i]
            probs_seq.append(probs)
        up = resize_bilinear(torch.stack(probs_seq), (hh * s, ww * s))
        lab = up.argmax(dim=-1).to(torch.uint8)
        return pack_labels(lab, bucket_mask_bits(o))

    # -- pipeline pieces ------------------------------------------------- #

    def upload(self, frames_u8, threads: int = 1) -> list:
        """Chunked host-to-device upload, each chunk encoded as soon as it
        is on the device. `frames_u8`: raw RGB (N, H, W, 3) uint8, or under
        ingest='yuv420' a (y, uv) pair already in planar YUV (the decoder's
        output; RGB is converted per chunk on the host). Returns per-chunk
        (features, embeddings)."""
        if isinstance(frames_u8, tuple):
            if self.ingest != "yuv420":
                raise ValueError("packed (y, uv) input needs ingest='yuv420'")
            y, uv = frames_u8
            chunks = [(y[i:i + CHUNK], uv[i:i + CHUNK])
                      for i in range(0, y.shape[0], CHUNK)]
        else:
            chunks = [frames_u8[i:i + CHUNK]
                      for i in range(0, frames_u8.shape[0], CHUNK)]
        if threads > 1:
            pool = self._ensure_upload_pool(threads)
            puts = [pool.submit(self._to_device, c) for c in chunks]
            return [self._extract(f.result()) for f in puts]
        return [self._extract(self._to_device(c)) for c in chunks]

    def host_frames(self, frames_u8: np.ndarray):
        """(B, T, H, W, 3) uint8 RGB -> `upload`'s input: the frames
        flattened to (B T, H, W, 3), or under ingest='yuv420' their planar
        YUV 4:2:0 (converted on the host)."""
        flat = frames_u8.reshape(-1, *frames_u8.shape[2:])
        return rgb_to_yuv420_host(flat) if self.ingest == "yuv420" else flat

    def _to_device(self, chunk):
        """One chunk to the device; an RGB chunk under ingest='yuv420' is
        converted on the host first."""
        if not isinstance(chunk, tuple):
            if self.ingest != "yuv420":
                return _upload(chunk, self.device)
            chunk = rgb_to_yuv420_host(chunk)
        return tuple(_upload(c, self.device) for c in chunk)

    def _ensure_upload_pool(self, threads: int):
        n, pool = self._upload_pool
        if n != threads:
            if pool is not None:
                pool.shutdown(wait=False)
            pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix="frame-upload")
            self._upload_pool = (threads, pool)
        return pool

    @torch.inference_mode()
    def dispatch(self, extracted: list, first_masks: np.ndarray,
                 num_objects: np.ndarray, batch_shape: tuple):
        """Propagate every sequence, each in its own object bucket, and
        hand its packed masks to the download pool. -> (download futures,
        bits per sequence)."""
        b, t = batch_shape
        n_obj = [int(n) for n in np.asarray(num_objects)]
        buckets = [object_bucket_for(n, self.o) for n in n_obj]
        bits_list = [bucket_mask_bits(ob) for ob in buckets]
        # validated before any device work: the bit-packing needs the
        # upsampled width divisible by 8 / bits
        w_img = extracted[0][0].shape[2] * self.cfg.model.feature_stride
        for bits in set(bits_list):
            if w_img % (8 // bits):
                raise ValueError(f"width {w_img} must be a multiple of "
                                 f"{8 // bits} (pad_to)")
        feat = torch.cat([f for f, _ in extracted])
        emb = torch.cat([e for _, e in extracted])
        hh, ww = feat.shape[1:3]
        feat = feat.reshape(b, t, hh, ww, -1)
        emb = emb.reshape(b, t, hh, ww, -1)
        fm = torch.as_tensor(np.asarray(first_masks), device=self.device)
        fetches = []
        for i in range(b):
            ov = torch.zeros((buckets[i],), dtype=torch.float32,
                             device=self.device)
            ov[:n_obj[i] + 1] = 1.0
            packed = self._one_seq(feat[i], emb[i], fm[i], ov, buckets[i])
            fetches.append(_FETCH_POOL.submit(_download, packed))
        return fetches, bits_list

    @staticmethod
    def drain(fetches, bits) -> np.ndarray:
        """Wait for the downloads (`dispatch`'s futures and bits per
        sequence); -> (B, T, H, W) int32 labels."""
        labs = [unpack_labels(f.result(), b) for f, b in zip(fetches, bits)]
        return np.stack(labs).astype(np.int32)

    def propagate(self, frames_u8: np.ndarray, first_masks: np.ndarray,
                  num_objects: np.ndarray) -> np.ndarray:
        """frames_u8 (B, T, H, W, 3) uint8; first_masks (B, h, w) int at
        feature resolution; num_objects (B,) -> (B, T, H, W) int32."""
        b, t, h_img, w_img, _ = frames_u8.shape
        extracted = self.upload(frames_u8.reshape(b * t, h_img, w_img, 3))
        fetches, bits = self.dispatch(extracted, first_masks, num_objects,
                                      (b, t))
        return self.drain(fetches, bits)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _download(packed: torch.Tensor) -> np.ndarray:
    return packed.cpu().numpy()


# --------------------------------------------------------------------- #
# Throughput CLI: fixed (B, T, H, W) batches from the synthetic fixture or
# a DAVIS or YouTube-VOS tree through BatchPropagator, reported as one JSON
# metric line.
# --------------------------------------------------------------------- #

def _load_batches(ds, batch: int, stride: int):
    """Yield (frames_u8 (B, T, H, W, 3), first_masks (B, h, w),
    num_objects (B,)) from the synthetic fixture, whose clips are made at
    the padded size and the requested length (its frames are RGB in
    [0, 1])."""
    names = ds.sequences()
    for i in range(0, len(names), batch):
        seqs = names[i:i + batch]
        fr = [(np.clip(ds.images(q), 0, 1) * 255).astype(np.uint8)
              for q in seqs]
        fm = [ds.gt_masks(q)[0, ::stride, ::stride] for q in seqs]
        yield (np.stack(fr), np.stack(fm).astype(np.int32),
               np.asarray([ds.num_objects(q) for q in seqs], np.int32))


def _load_adapter_batches(ds, batch: int, frames: int, image_hw,
                          stride: int):
    """Yield (frames_u8 (B, T, H, W, 3), first_masks (B, h, w),
    num_objects (B,)) from an eval-style adapter (a DAVIS or YouTube-VOS
    tree), as the
    JAX CLI's loader does: the normalized frames are un-normalized and
    truncated to uint8, short sequences are padded by repeating the last
    frame, long ones sliced to `frames`, and the spatial size padded (or
    cropped) to `image_hw`. The tail yields a smaller final batch."""
    from cvpr2020_manet_tpu_torch.data.davis import IMAGENET_MEAN, IMAGENET_STD
    h_img, w_img = image_hw
    names = ds.sequences()
    for i in range(0, len(names), batch):
        fr, fm, no = [], [], []
        for seq in names[i:i + batch]:
            imgs = ds.images(seq)      # normalized float (T, H, W, 3)
            gt = ds.gt_masks(seq)
            u8 = np.clip((imgs * IMAGENET_STD + IMAGENET_MEAN) * 255.0,
                         0, 255).astype(np.uint8)
            t = u8.shape[0]
            if t < frames:
                pad = np.repeat(u8[-1:], frames - t, axis=0)
                u8 = np.concatenate([u8, pad], axis=0)
            u8 = u8[:frames, :h_img, :w_img]
            if u8.shape[1:3] != (h_img, w_img):
                py, px = h_img - u8.shape[1], w_img - u8.shape[2]
                u8 = np.pad(u8, ((0, 0), (0, py), (0, px), (0, 0)))
                gt = np.pad(gt, ((0, 0), (0, py), (0, px)))
            fr.append(u8)
            fm.append(gt[0, :h_img:stride, :w_img:stride])
            no.append(ds.num_objects(seq))
        yield (np.stack(fr), np.stack(fm).astype(np.int32),
               np.asarray(no, np.int32))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_batches(prop: BatchPropagator, batches: list, threads: int = 1):
    """Wall times of `batches` [(frames_u8 (B, T, H, W, 3), first_masks,
    num_objects)], each put in the upload format before the clock: under
    ingest='yuv420' production input is the decoder's planar YUV, so the
    conversion is the harness's cost.

    - serial: upload, dispatch and drain of one batch after another;
    - pipelined: batch i+1's upload (`threads`) is issued between batch
      i's dispatch and drain, under batch i's device work; batch 0's
      upload (and its encoder work) is inside the clock, so that a short
      run does not leave one batch's upload out of its mean.

    -> (serial seconds per batch, pipelined seconds per batch, the serial
    runs' (B, T, H, W) labels)."""
    uploads = [prop.host_frames(fr) for fr, _, _ in batches]
    serial, labels = [], []
    for up, (fr, fm, no) in zip(uploads, batches):
        _sync(prop.device)
        t0 = time.perf_counter()
        fetches, bits = prop.dispatch(prop.upload(up), fm, no, fr.shape[:2])
        labels.append(prop.drain(fetches, bits))
        serial.append(time.perf_counter() - t0)
    _sync(prop.device)
    t0 = time.perf_counter()
    ex = prop.upload(uploads[0], threads=threads)
    for i, (fr, fm, no) in enumerate(batches):
        fetches, bits = prop.dispatch(ex, fm, no, fr.shape[:2])
        if i + 1 < len(batches):
            ex = prop.upload(uploads[i + 1], threads=threads)
        prop.drain(fetches, bits)
    return serial, (time.perf_counter() - t0) / len(batches), labels


def main(argv=None):
    import argparse
    import json

    from cvpr2020_manet_tpu_torch.config import tiny_test_config
    from cvpr2020_manet_tpu_torch.data import SyntheticDataset
    from cvpr2020_manet_tpu_torch.utils.checkpoint import load_release

    p = argparse.ArgumentParser()
    p.add_argument("--dataset", choices=["synthetic", "davis", "ytvos"],
                   default="synthetic")
    p.add_argument("--data_root", default=None,
                   help="DAVIS or YouTube-VOS tree (--dataset davis|ytvos)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--image_size", type=int, nargs=2, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="release export directory (utils/checkpoint.py)")
    p.add_argument("--timed_batches", type=int, default=4)
    p.add_argument("--upload_threads", type=int, default=1,
                   help="threads issuing the per-chunk frame uploads")
    p.add_argument("--ingest", choices=["rgb", "yuv420"], default="rgb",
                   help="frame upload format: yuv420 halves the bytes "
                        "(colorspace inverse on the device)")
    p.add_argument("--matching_int8", action="store_true",
                   help="int8 global matching (the serving mode), through "
                        "the model's matching backend")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)

    cfg = tiny_test_config() if args.tiny else Config()
    image_hw = tuple(args.image_size) if args.image_size \
        else cfg.eval.image_size
    h_img = image_hw[0] + (-image_hw[0]) % cfg.eval.pad_to
    w_img = image_hw[1] + (-image_hw[1]) % cfg.eval.pad_to
    s = cfg.model.feature_stride
    if args.dataset in ("davis", "ytvos"):
        if args.dataset == "davis":
            from cvpr2020_manet_tpu_torch.data.davis import DavisEvalDataset
            ds = DavisEvalDataset(args.data_root)
        else:
            from cvpr2020_manet_tpu_torch.data.ytvos import YTVOSDataset
            ds = YTVOSDataset(args.data_root)
        gen = _load_adapter_batches(ds, args.batch, args.frames,
                                    (h_img, w_img), s)
    else:
        ds = SyntheticDataset(
            image_size=(h_img, w_img), num_frames=args.frames,
            num_sequences=args.batch * (args.timed_batches + 1),
            num_objects=2, scribble_sets=1)
        gen = _load_batches(ds, args.batch, s)

    device = resolve_device(None)
    model = MANet(cfg.model, device=device, matching_backend=(
        "int8" if args.matching_int8 else "auto"))
    if args.checkpoint:
        model.load_state_dict(load_release(model.state_dict(),
                                           args.checkpoint))
    prop = BatchPropagator(cfg, model, ingest=args.ingest, device=device)

    first = next(gen, None)
    if first is None:
        raise SystemExit(f"dataset has no sequences "
                         f"({args.dataset}, root={args.data_root})")
    timed = []
    for batch in gen:
        timed.append(batch)
        if len(timed) >= args.timed_batches:
            break
    if not timed:
        timed = [first]
    prop.propagate(*first)                 # warm-up

    times, t_pipe, _ = timed_batches(prop, timed, args.upload_threads)

    # the device path alone: inputs uploaded and encoded beforehand
    ex = prop.upload(prop.host_frames(first[0]))
    _sync(device)
    dev_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        fetches, bits = prop.dispatch(ex, first[1], first[2],
                                      first[0].shape[:2])
        prop.drain(fetches, bits)
        dev_times.append(time.perf_counter() - t0)
    t_device = float(np.median(dev_times))

    frames_total = args.batch * args.frames
    print(json.dumps({
        "metric": "batched_propagation_fps",
        "value": round(frames_total / t_pipe, 2), "unit": "frames/s",
        "fps_serial": round(frames_total / float(np.median(times)), 2),
        "batch": args.batch, "frames": args.frames,
        "image_size": [h_img, w_img], "timed_batches": len(timed),
        # share of the pipelined wall time that the device path (compute
        # and mask download) accounts for; 1.0 = uploads fully hidden
        "device_busy_fraction": round(t_device / t_pipe, 3),
        "device": str(device),
    }))
    return 0


if __name__ == "__main__":
    main()
