"""Run the flagship 480p serving bundle on the card and hold its masks
against the live model's: the counterpart of the JAX package's
`scripts/run_artifact_tpu.py`.

    python -m cvpr2020_manet_tpu_torch.run_artifact [--frames 8] \\
        [--objects 3] [--rounds 3] [--release DIR] [--keep PATH] \\
        [--tiny] [--cpu]

Exports the five-entry serving bundle (`utils/export.
export_serving_bundle`: uint8 frames, kernels 1 and 2 as the ops
`manet::*` inside the graphs), writes it (`save_bundle`, to `--keep` or a
temporary file), loads it back (`load_bundle`), and drives one full
interactive round of a synthetic sequence through the bundle's entries
`--rounds` times (the first pays the first-call costs): extract every
frame, interact on frame 0, aggregate_first, then propagate frames 1..T-1,
each from the previous frame's prediction, with the global map min-fused
as the Evaluator's `min_fused` memory does. Then the same round through
the live entry functions (`build_serving_fns`, with `wrap_raw_image`) on
the same model, and the argmax masks of the two are compared bit for bit.

Prints one JSON line {"metric": "ivosx_bundle_round", ...}: the JAX
script's keys ("platform" is the torch device type), and "device". Exits
1 when the masks are not bitwise equal and agree on less than 0.999 of
the pixels. The weights are seeded random (the parity and the time do not
depend on them), or a port release with `--release` (`utils/checkpoint.
load_release`). Runs on the card, and raises without CUDA unless `--cpu`
is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.config import Config, tiny_test_config
from cvpr2020_manet_tpu_torch.device import tool_device


def drive(entries, frames, pos, obj_valid) -> np.ndarray:
    """One interactive round through the five-entry contract -> (T, h, w)
    argmax labels: extract every frame, interact on frame 0,
    aggregate_first, then propagate frames 1..T-1 from the previous
    prediction with the global map min-fused across frames."""
    hh, ww, o = pos.shape
    feats, embs = zip(*(entries["extract"](f) for f in frames))
    neg = torch.zeros_like(pos)
    bg = torch.zeros_like(pos)
    bg[..., 0] = 1.0
    int_feats, probs0 = entries["interact"](feats[0], pos, neg, bg)
    mem = entries["aggregate_first"](int_feats)
    lab0 = probs0.argmax(dim=-1)
    ref_onehot = F.one_hot(lab0.reshape(-1), o).float()
    ref_emb = embs[0].reshape(-1, embs[0].shape[-1])
    gmap = torch.ones((hh, ww, o), device=pos.device)
    masks, prev_probs, prev_emb = [lab0], probs0, embs[0]
    for t in range(1, len(frames)):
        probs, gmap = entries["propagate"](
            feats[t], embs[t], ref_emb, ref_onehot, gmap, prev_emb,
            prev_probs, mem, obj_valid)
        masks.append(probs.argmax(dim=-1))
        prev_probs, prev_emb = probs, embs[t]
    return torch.stack(masks).cpu().numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--objects", type=int, default=3,
                   help="object bucket EXCLUDING background")
    p.add_argument("--release", default=None,
                   help="a port release directory (utils/checkpoint."
                        "export_release) for the weights; seeded random "
                        "otherwise")
    p.add_argument("--keep", default=None,
                   help="write the bundle here (default: a temporary file)")
    p.add_argument("--rounds", type=int, default=3,
                   help="timed bundle-driven rounds (the first pays the "
                        "first-call costs)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    dev, device_name = tool_device(args.cpu)

    from cvpr2020_manet_tpu_torch.models import MANet
    from cvpr2020_manet_tpu_torch.utils import export as ex
    cfg = tiny_test_config() if args.tiny else Config()
    h, w = cfg.eval.image_size
    pad_to = cfg.eval.pad_to
    hh, ww = (h + (-h) % pad_to) // 4, (w + (-w) % pad_to) // 4
    o = args.objects + 1
    model = MANet(cfg.model, device=dev, seed=0).eval()
    if args.release:
        from cvpr2020_manet_tpu_torch.utils.checkpoint import load_release
        model.load_state_dict(load_release(model.state_dict(), args.release))

    with tempfile.TemporaryDirectory() as tmp:
        path = args.keep or os.path.join(tmp, "flagship.ivosx")
        t0 = time.perf_counter()
        exports = ex.export_serving_bundle(model, (h, w), args.objects,
                                           pad_to=pad_to)
        manifest = ex.save_bundle(
            exports, path, extra={"image_size": [h, w],
                                  "objects": args.objects})
        t_export = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
        print(f"bundle exported: {path} ({size_mb:.1f} MB, {t_export:.1f}s, "
              f"device={manifest['entries']['propagate']['device']})",
              flush=True)
        bundle = ex.load_bundle(path)

    rng = np.random.default_rng(7)
    frames = torch.as_tensor(
        rng.integers(0, 256, (args.frames, h, w, 3)).astype(np.uint8),
        device=dev)
    pos = torch.zeros((hh, ww, o), device=dev)
    pos[8:24, 8:40, 1] = 1.0
    if o > 2:
        pos[40:56, 60:90, 2] = 1.0
    obj_valid = torch.ones((o,), device=dev)

    bundle_entries = {n: bundle[n] for n in bundle.names}
    times = []
    for r in range(max(2, args.rounds)):
        t0 = time.perf_counter()
        bundle_masks = drive(bundle_entries, frames, pos, obj_valid)
        times.append(time.perf_counter() - t0)
        print(f"bundle round {r}: {times[-1]:.2f}s", flush=True)

    fns = ex.build_serving_fns(model, (h, w), args.objects, pad_to=pad_to)
    fns = dict(fns, extract=ex.wrap_raw_image(*fns["extract"]))
    with torch.inference_mode():
        live_masks = drive({n: fn for n, (fn, _) in fns.items()}, frames,
                           pos, obj_valid)

    bitwise = bool((bundle_masks == live_masks).all())
    agree = float((bundle_masks == live_masks).mean())
    warm = min(times[1:])
    print(json.dumps({
        "metric": "ivosx_bundle_round",
        "platform": dev.type,
        "image_size": [h, w],
        "frames": args.frames,
        "object_bucket": o,
        "bundle_mb": size_mb,
        "export_s": t_export,
        "warm_round_s": warm,
        "fps_equiv": args.frames / warm,
        "mask_parity_bitwise": bitwise,
        "mask_agreement": agree,
        "device": device_name,
    }))
    if not bitwise and agree < 0.999:
        print("FAIL: bundle masks diverge from the live model's",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
