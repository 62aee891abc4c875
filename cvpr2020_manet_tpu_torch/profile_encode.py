"""Device time of the encoder, stage by stage, each timed alone, with
analytic FLOPs: the counterpart of the JAX package's
`scripts/profile_encode.py`.

    python -m cvpr2020_manet_tpu_torch.profile_encode [--frames 8] \\
        [--iters 16] [--reps 3] [--cpu]

`MANet.extract_features` of the flagship `Config()` (seeded random
weights) split into the stem (7x7/2 conv, norm, relu, max-pool), the four
ResNet stages, the ASPP and the decoder with the embedding head: the
model's own submodules (`ResNetBackbone.stem`, `.stage`, `Encoder.aspp`,
`Encoder.decode`), each on its true input, which one pass of the chain
over `--frames` random 480p frames produces. Chained, the stages are
`extract_features` itself (`tests/test_torch_bench_scripts.py` holds them
bit for bit). Each is timed by the two-point slope
(`utils/profiling.slope_ms`): CUDA events over `--iters` and twice as many
back-to-back calls, best of `--reps`, the difference over `--iters`. Its
FLOPs are the JAX script's analytic count (`conv_flops`,
`bottleneck_flops`, `stage_flops`), so the ms and the achieved TFLOP/s say
which stage leaves the tensor cores idle. No matching kernel runs here:
it measures the convolutions, norms and glue of `PERF.md` §5.

Prints the JAX script's lines (a header, one line a stage), then one JSON
line {"metric": "encode_stages_ms", ...} whose value is the sum of the
stages' ms for the `--frames` frames. Runs on the card, and raises
without CUDA unless `--cpu` is given (the tiny config on the CPU: the
harness, not a bench).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from cvpr2020_manet_tpu_torch.config import (
    Config, ModelConfig, tiny_test_config)
from cvpr2020_manet_tpu_torch.device import tool_device
from cvpr2020_manet_tpu_torch.utils.profiling import elapsed_ms, slope_ms


def conv_flops(h, w, cin, cout, k):
    return 2.0 * h * w * cin * cout * k * k


def bottleneck_flops(h, w, cin, ch, stride, with_shortcut):
    """One Bottleneck at INPUT resolution (h, w)."""
    ho, wo = h // stride, w // stride
    f = conv_flops(h, w, cin, ch, 1)            # conv1 (pre-stride)
    f += conv_flops(ho, wo, ch, ch, 3)          # conv2 (strided)
    f += conv_flops(ho, wo, ch, ch * 4, 1)      # conv3
    if with_shortcut:
        f += conv_flops(ho, wo, cin, ch * 4, 1)
    return f


def stage_table(mc: ModelConfig) -> list[tuple[int, int]]:
    """(stride, dilation) of the four ResNet stages at the output stride."""
    if mc.output_stride == 16:
        return [(1, 1), (2, 1), (2, 1), (1, 2)]
    return [(1, 1), (2, 1), (1, 2), (1, 4)]


def stage_names(mc: ModelConfig) -> list[str]:
    return (["stem"]
            + [f"stage{i + 1}(x{n})" for i, n in enumerate(mc.backbone_depths)]
            + ["aspp", "decoder+emb"])


def stage_flops(mc: ModelConfig, hp: int, wp: int) -> dict[str, float]:
    """FLOPs of each stage for ONE (hp, wp) frame, counted as the JAX
    script counts them (its per-stage sums)."""
    flops = {"stem": conv_flops(hp // 2, wp // 2, 3, mc.backbone_width, 7)}
    hh, ww = hp // 4, wp // 4
    cin, cur_h, cur_w = mc.backbone_width, hh, ww
    for stage, (n_blocks, (stride, _)) in enumerate(
            zip(mc.backbone_depths, stage_table(mc))):
        ch = mc.backbone_width * (2 ** stage)
        fl = bottleneck_flops(cur_h, cur_w, cin, ch, stride, True)
        fl += (n_blocks - 1) * bottleneck_flops(
            cur_h // stride, cur_w // stride, ch * 4, ch, 1, False)
        flops[f"stage{stage + 1}(x{n_blocks})"] = fl
        cur_h, cur_w = cur_h // stride, cur_w // stride
        cin = ch * 4
    ca = mc.aspp_channels
    fl = conv_flops(cur_h, cur_w, cin, ca, 1)           # 1x1 branch
    fl += 3 * conv_flops(cur_h, cur_w, cin, ca, 3)      # 3 atrous branches
    fl += conv_flops(1, 1, cin, ca, 1)                  # pooled branch
    fl += conv_flops(cur_h, cur_w, 5 * ca, ca, 1)       # projection
    flops["aspp"] = fl
    cd, cl = mc.decoder_channels, mc.low_level_channels
    fl = conv_flops(hh, ww, mc.backbone_width * 4, cl, 1)
    fl += conv_flops(hh, ww, ca + cl, cd, 3)
    fl += conv_flops(hh, ww, cd, cd, 3)
    fl += conv_flops(hh, ww, cd, mc.embedding_dim, 1)
    flops["decoder+emb"] = fl
    return flops


def stage_calls(model, images: torch.Tensor):
    """-> [(stage name, fn, its input)]: the encoder's stages on their
    inputs from one pass of the chain over `images` (N, H, W, 3), and that
    pass's (feature, embedding) in `extract_features`' layout."""
    enc = model.encoder
    bb = enc.backbone
    names = stage_names(model.cfg)
    x = images.permute(0, 3, 1, 2)          # extract_features' NCHW view
    calls = [(names[0], bb.stem, x)]
    x = bb.stem(x)
    low = None
    for i in range(len(bb.block_names)):
        calls.append((names[i + 1], lambda v, i=i: bb.stage(i, v), x))
        x = bb.stage(i, x)
        if i == 0:
            low = x
    calls.append(("aspp", enc.aspp, x))
    y = enc.aspp(x)
    calls.append(("decoder+emb", lambda v: enc.decode(v, low), y))
    feat, emb = enc.decode(y, low)
    return calls, (feat.permute(0, 2, 3, 1), emb.permute(0, 2, 3, 1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cpu", action="store_true",
                   help="tiny config on the CPU (the harness, not a bench)")
    args = p.parse_args(argv)
    dev, device_name = tool_device(args.cpu)

    from cvpr2020_manet_tpu_torch.models import MANet
    cfg = tiny_test_config() if args.cpu else Config()
    mc = cfg.model
    model = MANet(mc, device=dev, seed=0).eval()
    h, w = cfg.eval.image_size
    hp, wp = h + (-h) % cfg.eval.pad_to, w + (-w) % cfg.eval.pad_to
    n = args.frames
    flops = stage_flops(mc, hp, wp)
    print(f"profile_encode: {hp}x{wp} N={n} dtype={mc.dtype} "
          f"norm={mc.norm} device={device_name}", flush=True)
    stages = {}
    with torch.inference_mode():
        images = torch.randn((n, hp, wp, 3),
                             generator=torch.Generator().manual_seed(0))
        calls, _ = stage_calls(model, images.to(dev))
        for name, fn, x in calls:
            first_s = elapsed_ms(lambda: fn(x), 1, dev) / 1e3
            ms, _ = slope_ms(lambda: fn(x), args.iters, args.reps, dev)
            tf = flops[name] * n / ms / 1e9
            stages[name] = {"ms": ms, "ms_per_frame": ms / n, "tflops": tf}
            print(f"  {name:<16} {ms:8.3f} ms ({ms / n:6.3f} ms/frame"
                  f", {tf:6.1f} TFLOP/s, first {first_s:.1f}s)", flush=True)
    print(json.dumps({
        "metric": "encode_stages_ms",
        "value": sum(s["ms"] for s in stages.values()),
        "unit": "ms/chunk",
        "frames": n,
        "image_size": [hp, wp],
        "stages": stages,
        "device": device_name,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
