"""Export CLI: `torch.export` serving artifacts (.ivosx), the port of the
JAX package's `manet-export` (see utils/export.py and docs/SERVING.md).

Examples:
  # flagship 480p, 8-object bucket, exported on the card
  python -m cvpr2020_manet_tpu_torch.utils.export_cli --out manet_480p.ivosx

  # the serving bundle in the int8 matching mode, from a release
  python -m cvpr2020_manet_tpu_torch.utils.export_cli --out b.ivosx \\
      --bundle --matching_backend int8 --release /ckpts/release

  # round-trip self-check on the CPU (loads the file back, compares every
  # entry with a direct call of the live module)
  python -m cvpr2020_manet_tpu_torch.utils.export_cli --tiny --bundle \\
      --check --device cpu --out /tmp/b.ivosx

An artifact runs on the device it was exported on (`--device`, `cuda`
unless the caller asks for the CPU); `load_artifact(path, device=...)`
moves it to another. JAX's `--platforms` is refused with a pointer to
`--device`, and its matching backends other than `auto` and `int8`
(the Pallas / jnp choices) have no counterpart here.
"""

import argparse
import json

import numpy as np
import torch

from cvpr2020_manet_tpu_torch.device import resolve_device


def _rand_like(rng, a: torch.Tensor) -> torch.Tensor:
    """Random check input matching an example arg's shape/dtype/device."""
    if a.dtype.is_floating_point:
        x = torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32))
    else:
        x = torch.from_numpy(rng.integers(0, 256, a.shape))
    return x.to(dtype=a.dtype, device=a.device)


def _assert_close(got, want, atol: float) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs, {len(want)} expected")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), atol=atol)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=854)
    p.add_argument("--objects", type=int, default=None,
                   help="object bucket (default: config max_objects)")
    p.add_argument("--device", default=None,
                   help="device to export on and serve from (default cuda)")
    p.add_argument("--platforms", default=None,
                   help="JAX's flag; refused: use --device")
    p.add_argument("--matching_backend", default="auto",
                   help="auto (the f32 / bf16 kernels) or int8 (the int8 "
                        "serving mode); others raise")
    p.add_argument("--release", default=None,
                   help="load params from an export_release directory")
    p.add_argument("--tiny", action="store_true",
                   help="tiny test config (CI / smoke)")
    p.add_argument("--bundle", action="store_true",
                   help="write a serving BUNDLE (extract/interact/"
                        "aggregate/propagate graphs) instead of the "
                        "single fused round artifact")
    p.add_argument("--image_format", default=None,
                   choices=["uint8", "float32", "yuv420"],
                   help="artifact image contract: uint8 RGB (default), "
                        "pre-normalized float32, or the decoder's planar "
                        "YUV 4:2:0 (y, uv) pair at half the RGB bytes")
    p.add_argument("--float_image", action="store_true",
                   help="image input stays normalized float32 (default: "
                        "raw uint8 RGB, normalization inside the graph)")
    p.add_argument("--check", action="store_true",
                   help="load the artifact back and compare vs direct call")
    args = p.parse_args(argv)
    if args.platforms is not None:
        raise SystemExit("--platforms is the JAX package's flag: an "
                         "artifact here is exported on one device, "
                         "--device cpu|cuda (load_artifact(path, device=) "
                         "moves it to another)")

    from cvpr2020_manet_tpu_torch.config import Config, tiny_test_config
    from cvpr2020_manet_tpu_torch.models import MANet
    from cvpr2020_manet_tpu_torch.utils import export as ex

    cfg = tiny_test_config() if args.tiny else Config()
    h, w = (cfg.eval.image_size if args.tiny else (args.height, args.width))
    num_objects = (args.objects if args.objects is not None
                   else cfg.model.max_objects)
    pad_to = cfg.eval.pad_to

    # MANet refuses a matching backend other than auto and int8
    model = MANet(cfg.model, device=resolve_device(args.device), seed=0,
                  matching_backend=args.matching_backend).eval()
    if args.release:
        from cvpr2020_manet_tpu_torch.utils.checkpoint import load_release
        model.load_state_dict(load_release(model.state_dict(), args.release))

    fmt = args.image_format or ("float32" if args.float_image else "uint8")
    extra = {
        # image_size + pad_to + feature_stride define the artifact's
        # spatial contract: the scribble/probability grid is
        # (H + (-H) % pad_to) // stride per side
        "image_size": [h, w], "pad_to": pad_to, "feature_stride": 4,
        "image_input": {"uint8": "uint8_rgb",
                        "float32": "normalized_float32",
                        "yuv420": "yuv420_planar"}[fmt],
        "num_objects": num_objects,
        "matching_backend": args.matching_backend,
        "release": args.release or "",
    }
    if args.bundle:
        exports = ex.export_serving_bundle(model, (h, w), num_objects,
                                           pad_to=pad_to, image_format=fmt)
        manifest = ex.save_bundle(exports, args.out, extra=extra)
    else:
        exported = ex.export_forward(model, (h, w), num_objects,
                                     pad_to=pad_to, image_format=fmt)
        manifest = ex.save_artifact(exported, args.out, extra=extra)
    print(json.dumps(manifest, sort_keys=True))

    if not args.check:
        return
    wrap = ex.IMAGE_WRAPPERS[fmt]
    rng = np.random.default_rng(0)
    if args.bundle:
        bundle = ex.load_bundle(args.out)
        fns = ex.build_serving_fns(model, (h, w), num_objects, pad_to=pad_to)
        if wrap is not None:
            fns = dict(fns, extract=wrap(*fns["extract"]))
        checks = [(bundle[name], *fns[name]) for name in bundle.names]
    else:
        fn, example_args = ex.build_round_forward(model, (h, w), num_objects,
                                                  pad_to=pad_to)
        if wrap is not None:
            fn, example_args = wrap(fn, example_args)
        checks = [(ex.load_artifact(args.out), fn, example_args)]
    for loaded, fn, example_args in checks:
        argv_ = [_rand_like(rng, a) for a in example_args]
        with torch.no_grad():
            _assert_close(loaded(*argv_), fn(*argv_), atol=1e-5)
    print("check: all bundle entries match direct apply" if args.bundle
          else "check: artifact output matches direct apply")


if __name__ == "__main__":
    main()
