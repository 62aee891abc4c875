"""Device time of the 480p interactive round, stage by stage, each timed
alone: the counterpart of the JAX package's `scripts/profile_stages.py`.

    python -m cvpr2020_manet_tpu_torch.profile_stages [--frames 16] \\
        [--iters 8] [--reps 3] [--int8] [--cpu]

The round of `Evaluator.dispatch_round` (flagship `Config()`, seeded
random weights, a `--frames` frame bucket, a 4-wide object bucket) split
into the stages it runs, on inputs of their true shapes:

  encode        `extract_features` of one 8-frame chunk (`start_sequence`)
  prepare_ref   bucketing the annotated frame's rows by object
  matching      global matching of the T-1 other frames, one call
                (kernel 1)
  sweep_step    the (T-1)-step sweep: local matching (kernel 2), the
                decomposed propagation head and the softmax, with the
                global matching hoisted out (`gmap_override`)
  labels        upsampling and argmax of the T masks
                (`Evaluator._labels_impl`), then their crop to the image
                and int32 cast (`engine/labels.crop_labels`)

and with `--int8` also the int8 pair (`prepare_ref_int8`, kernel 3 on the
same queries). Each stage is timed by the two-point slope
(`utils/profiling.slope_ms`): CUDA events over `--iters` and twice as many
back-to-back calls, best of `--reps`, the difference over `--iters`, so
that a run's fixed costs cancel. Chained on one sequence, the stages give
the Evaluator's first-round masks (`tests/test_torch_bench_scripts.py`).

Prints the JAX script's lines (a header, one line a stage, then "round
stages total (excl. encode): X ms/round"; the total is the default
round's, without the int8 pair), then one JSON line {"metric":
"round_stages_ms", ...}. Runs on the card, and raises without CUDA unless
`--cpu` is given (the tiny config on the CPU: the harness, not a bench).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from cvpr2020_manet_tpu_torch.config import Config, tiny_test_config
from cvpr2020_manet_tpu_torch.device import tool_device
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.engine.labels import crop_labels
from cvpr2020_manet_tpu_torch.utils.profiling import elapsed_ms, slope_ms

ENCODE_CHUNK = 8     # Evaluator.start_sequence's frames a chunk


def prepare(model, emb0: torch.Tensor, ref_onehot: torch.Tensor):
    """The annotated frame's embedding (h, w, C) and the rows' one-hot
    labels (h w, O) -> the bucketed reference."""
    return model.prepare_ref(emb0.reshape(-1, emb0.shape[-1]), ref_onehot)


def match(model, emb: torch.Tensor, bucketed) -> torch.Tensor:
    """(T-1, h, w, C) embeddings of the other frames -> their global maps
    (T-1, h, w, O), one matching call."""
    t, h, w, c = emb.shape
    return model.match_prepared(emb.reshape(-1, c), bucketed).reshape(
        t, h, w, -1)


def sweep(model, feat, emb, ref_emb, ref_onehot, gm_pre, gmap, head_fp,
          head_mp, int_mem, obj_valid, carry) -> torch.Tensor:
    """The round's sweep from an annotated frame 0 forward, as
    `Evaluator._sweep_impl` steps it: frame f = 1..T-1 propagates from frame
    f-1's probabilities (`carry`: the interaction output first) with the
    precomputed global map gm_pre[f-1] min-fused into gmap[f]. -> the
    probabilities of frames 1..T-1, (T-1, h, w, O)."""
    out = []
    for f in range(1, feat.shape[0]):
        logits, _ = model.propagate(
            feat[f], emb[f], ref_emb, ref_onehot, None, gmap[f], emb[f - 1],
            carry, int_mem, obj_valid, gmap_override=gm_pre[f - 1],
            head_pre=head_fp[f][None] + head_mp)
        carry = torch.softmax(logits, dim=-1)
        out.append(carry)
    return torch.stack(out)


def round_labels(probs: torch.Tensor, mask_hw: tuple[int, int],
                 image_hw: tuple[int, int], mask_stride: int) -> torch.Tensor:
    """(T, h, w, O) probabilities -> (T, H, W) int32 labels of the image,
    on the probabilities' device, as `Evaluator.collect_round` downloads
    them."""
    return crop_labels(Evaluator._labels_impl(probs, hw=mask_hw), image_hw,
                       mask_stride)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cpu", action="store_true",
                   help="tiny shapes on the CPU (the harness, not a bench)")
    p.add_argument("--int8", action="store_true",
                   help="also time the int8 pair (prepare_ref_int8, kernel "
                        "3) at the same shapes")
    args = p.parse_args(argv)
    dev, device_name = tool_device(args.cpu)

    from cvpr2020_manet_tpu_torch.models import MANet
    from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
        global_matching_prepared_int8, prepare_ref_int8)
    cfg = tiny_test_config() if args.cpu else Config()
    model = MANet(cfg.model, device=dev, seed=0).eval()
    h, w = cfg.eval.image_size
    hp, wp = h + (-h) % cfg.eval.pad_to, w + (-w) % cfg.eval.pad_to
    hh, ww = hp // 4, wp // 4
    o = cfg.model.max_objects + 1 if args.cpu else 4
    t = args.frames
    ce = cfg.model.embedding_dim_padded
    g = torch.Generator().manual_seed(0)

    def rand(*shape, dtype=torch.float32, normal=True):
        x = (torch.randn if normal else torch.rand)(shape, generator=g)
        return x.to(dev, dtype)

    rows = []      # (name, ms a unit, ms a call, TFLOP/s or None)

    def timed(name, fn, per=1, flops=None):
        first_s = elapsed_ms(fn, 1, dev) / 1e3
        ms, fixed_ms = slope_ms(fn, args.iters, args.reps, dev)
        tf = flops / ms / 1e9 if flops else None
        rows.append((name, ms / per, ms, tf))
        print(f"  {name:<12} {ms / per:8.3f} ms/unit  ({ms:.2f} ms/iter "
              f"marginal, fixed {fixed_ms:.1f} ms, first {first_s:.1f}s"
              + (f", {tf:.1f} TFLOP/s" if tf else "") + ")", flush=True)

    print(f"profile_stages: {h}x{w} T={t} O={o} C={ce} device={device_name}",
          flush=True)
    with torch.inference_mode():
        chunk = min(ENCODE_CHUNK, t)
        imgs = rand(chunk, hp, wp, 3)
        timed(f"encode({chunk}f)", lambda: model.extract_features(imgs),
              per=chunk)

        md = model.dtype
        feat = rand(t, hh, ww, cfg.model.decoder_channels, dtype=md)
        emb = rand(t, hh, ww, ce, dtype=md)
        labels = torch.randint(0, o, (hh * ww,), generator=g)
        onehot = torch.nn.functional.one_hot(labels, o).to(dev, torch.float32)
        ones = torch.ones((t, hh, ww, o), device=dev)
        prev = torch.zeros((hh, ww, o), device=dev)
        prev[..., 0] = 1.0
        int_mem = rand(o, hh, ww, cfg.model.ma_channels)
        obj_valid = torch.ones((o,), device=dev)

        timed("prepare_ref", lambda: prepare(model, emb[0], onehot))
        bucketed = prepare(model, emb[0], onehot)
        flops = 2.0 * (t - 1) * hh * ww * bucketed.neg2pixels.shape[0] * ce
        timed(f"matching({t - 1}f)", lambda: match(model, emb[1:], bucketed),
              per=t - 1, flops=flops)
        if args.int8:
            ref = emb[0].reshape(-1, ce)
            timed("prepare_ref_int8", lambda: prepare_ref_int8(ref, onehot))
            bucketed8 = prepare_ref_int8(ref, onehot)
            q_all = emb[1:].reshape(-1, ce)
            timed(f"matching_int8({t - 1}f)",
                  lambda: global_matching_prepared_int8(q_all, bucketed8),
                  per=t - 1, flops=flops)

        head_fp = model.head_feat_contrib(feat)
        head_mp = model.head_mem_contrib(int_mem)
        gm_pre = rand(t - 1, hh, ww, o, normal=False)
        timed(f"sweep_step(x{t - 1})", lambda: sweep(
            model, feat, emb, emb[0].reshape(-1, ce), onehot, gm_pre, ones,
            head_fp, head_mp, int_mem, obj_valid, prev), per=t - 1)

        probs = rand(t, hh, ww, o, normal=False)
        ms = cfg.eval.mask_stride
        timed(f"labels({t}f)", lambda: round_labels(
            probs, (hp // ms, wp // ms), (h, w), ms), per=t)

    calls = {name: ms for name, _, ms, _ in rows}
    int8_pair = {"prepare_ref_int8", f"matching_int8({t - 1}f)"}
    round_rows = [r for r in rows[1:] if r[0] not in int8_pair]
    total = sum(ms for _, _, ms, _ in round_rows)
    print(f"round stages total (excl. encode): {total:.1f} ms/round",
          flush=True)
    record = {
        "metric": "round_stages_ms",
        "value": total,
        "unit": "ms/round",
        "image_size": [h, w],
        "frames": t,
        "object_bucket": o,
        "stages": {name: {"ms_per_unit": unit, "ms_per_call": ms,
                          **({"tflops": tf} if tf else {})}
                   for name, unit, ms, tf in rows},
        "matching_tflops": rows[2][3],
        "device": device_name,
    }
    if args.int8:
        record["round_int8_ms"] = (
            total - calls["prepare_ref"] - calls[f"matching({t - 1}f)"]
            + sum(calls[n] for n in int8_pair))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
