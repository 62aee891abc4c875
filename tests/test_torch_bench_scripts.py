"""The port's measuring entry points (`bench_train`, `bench_streaming`,
`bench_matching_kernel`, `profile_stages`, `profile_encode`,
`run_artifact`) against the JAX package's scripts of the same names
(`scripts/*.py`; `run_artifact_tpu.py` for `run_artifact`): their printed
lines on the CPU at tiny sizes, `profile_encode`'s FLOP counts against
the JAX script's, and the profilers' stages chained against the
computation they time."""

import importlib
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.config import ModelConfig, tiny_test_config
from cvpr2020_manet_tpu_torch.data import SyntheticDataset
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.interactive.scribbles import (
    annotated_frames, scribbles2mask)
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch import profile_encode, profile_stages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "cvpr2020_manet_tpu_torch"
TOOLS = ("bench_train", "bench_streaming", "bench_matching_kernel",
         "profile_stages", "profile_encode", "run_artifact")

# The keys of the JAX scripts' JSON lines; the port adds "device".
BENCH_TRAIN_KEYS = {  # scripts/bench_train.py:112-124
    "metric", "value", "unit", "ms_per_step", "batch", "crop",
    "stage2_rounds", "pipelined", "uint8", "devices", "final_loss"}
BENCH_STREAMING_KEYS = {  # scripts/bench_streaming.py:113-126
    "metric", "value", "unit", "image_size", "memory_pages", "live_pages",
    "num_objects", "mask_bits", "fps", "pipelined_ms_per_frame",
    "pipelined_fps", "ingest"}
RUN_ARTIFACT_KEYS = {  # scripts/run_artifact_tpu.py:153-166
    "metric", "platform", "image_size", "frames", "object_bucket",
    "bundle_mb", "export_s", "warm_round_s", "fps_equiv",
    "mask_parity_bitwise", "mask_agreement"}
# The other three JAX scripts print text only; the port prints their lines
# (the regexes, from the JAX script's print) and then a JSON line of its
# own with these keys.
BENCH_MATCHING_KEYS = {
    "metric", "value", "unit", "tflops", "kernel", "shape", "iters", "reps"}
PROFILE_STAGES_KEYS = {
    "metric", "value", "unit", "image_size", "frames", "object_bucket",
    "stages", "matching_tflops"}
PROFILE_ENCODE_KEYS = {
    "metric", "value", "unit", "frames", "image_size", "stages"}
BEST_LINE = r"best: \d+\.\d{3} ms/call, \d+\.\d TFLOP/s"  # :137-138
ROUND_LINE = r"round stages total \(excl\. encode\): \d+\.\d ms/round"  # :234
ENCODE_LINE = (r"  decoder\+emb +\d+\.\d{3} ms \( *\d+\.\d{3} ms/frame, "
               r"+\d+\.\d TFLOP/s, ")  # scripts/profile_encode.py:108-110

TINY_TRAIN = ["--tiny", "--cpu", "--batch", "1", "--crop", "32", "--steps",
              "1", "--warmup", "1"]
MATCH = ["--cpu", "--nq", "300", "--nk", "700", "--iters", "2", "--reps",
         "1"]
CASES = [
    ("bench_train", TINY_TRAIN, "train_stage1_clips_per_sec",
     BENCH_TRAIN_KEYS, None),
    ("bench_train", TINY_TRAIN + ["--stage", "2", "--pipelined",
                                  "--prefetch", "--uint8"],
     "train_stage2_clips_per_sec", BENCH_TRAIN_KEYS, None),
    ("bench_streaming", ["--tiny", "--cpu", "--image_size", "32", "48",
                         "--frames", "2"],
     "streaming_observe_p50_ms", BENCH_STREAMING_KEYS, None),
    ("bench_streaming", ["--tiny", "--cpu", "--image_size", "31", "47",
                         "--frames", "2", "--ingest", "yuv420"],
     "streaming_observe_p50_ms", BENCH_STREAMING_KEYS, None),
    ("bench_matching_kernel", MATCH, "matching_kernel_ms_per_call",
     BENCH_MATCHING_KEYS, BEST_LINE),
    ("bench_matching_kernel", MATCH + ["--int8"],
     "matching_kernel_ms_per_call", BENCH_MATCHING_KEYS, BEST_LINE),
    ("bench_matching_kernel", ["--cpu", "--local", "--iters", "1", "--reps",
                               "1"],
     "matching_kernel_ms_per_call", BENCH_MATCHING_KEYS, BEST_LINE),
    ("profile_stages", ["--cpu", "--frames", "4", "--iters", "1", "--reps",
                        "1", "--int8"],
     "round_stages_ms", PROFILE_STAGES_KEYS | {"round_int8_ms"}, ROUND_LINE),
    ("profile_encode", ["--cpu", "--frames", "2", "--iters", "1", "--reps",
                        "1"],
     "encode_stages_ms", PROFILE_ENCODE_KEYS, ENCODE_LINE),
    ("run_artifact", ["--tiny", "--cpu", "--frames", "2", "--rounds", "2"],
     "ivosx_bundle_round", RUN_ARTIFACT_KEYS, None),
]


def _run(capsys, tool, argv):
    rc = importlib.import_module(f"{PORT}.{tool}").main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, lines, json.loads(lines[-1])


@pytest.mark.parametrize("tool,argv,metric,keys,text", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_tool_prints_the_jax_scripts_line(capsys, tool, argv, metric, keys,
                                          text):
    """One JSON line last, with the JAX script's metric and keys plus
    "device"; the text-only scripts' lines before it."""
    rc, lines, rec = _run(capsys, tool, argv)
    assert rc == 0
    assert rec["metric"] == metric
    assert set(rec) == keys | {"device"}
    assert rec["device"] == "cpu"
    figure = rec["warm_round_s" if tool == "run_artifact" else "value"]
    assert figure > 0 and np.isfinite(figure)
    if text is not None:
        assert re.fullmatch(text, lines[-2]) or any(
            re.match(text, line) for line in lines[:-1]), lines
    if tool == "run_artifact":
        assert rec["mask_parity_bitwise"] is True
        assert rec["mask_agreement"] == 1.0
        assert rec["platform"] == "cpu"


def test_bench_train_pipelined_trains_as_the_synchronous_loop(capsys):
    """`--pipelined` (train_step(sync=False)) takes the same steps on the
    same batches: the same final loss, bit for bit. (Both loops alternate
    the two batches, the synchronous one anew after the warm-up, as in JAX:
    an even warm-up gives both the same order.)"""
    argv = TINY_TRAIN + ["--steps", "2", "--warmup", "2"]
    _, _, sync = _run(capsys, "bench_train", argv)
    _, _, pipe = _run(capsys, "bench_train", argv + ["--pipelined"])
    assert pipe["pipelined"] and not sync["pipelined"]
    assert pipe["final_loss"] == sync["final_loss"]


def test_run_artifact_keeps_the_bundle(capsys, tmp_path):
    path = tmp_path / "tiny.ivosx"
    rc, _, rec = _run(capsys, "run_artifact",
                      ["--tiny", "--cpu", "--frames", "3", "--rounds", "2",
                       "--objects", "1", "--keep", str(path)])
    assert rc == 0 and rec["mask_parity_bitwise"] is True
    assert rec["object_bucket"] == 2 and path.exists()


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_raises_without_cuda(monkeypatch, tool):
    """No `--cpu` and no card: the entry point raises, it does not move to
    the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        importlib.import_module(f"{PORT}.{tool}").main([])


# ------------------------------------------------- profile_encode's FLOPs

def _jax_profile_encode():
    """scripts/profile_encode.py, whose module level imports no JAX."""
    spec = importlib.util.spec_from_file_location(
        "jax_profile_encode",
        os.path.join(REPO, "scripts", "profile_encode.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_stage_sums(jax_mod, mc, hp, wp):
    """The per-stage FLOPs of one frame as scripts/profile_encode.py's main
    sums them (:146-251), from its own conv_flops / bottleneck_flops."""
    cf, bf = jax_mod.conv_flops, jax_mod.bottleneck_flops
    out = {"stem": cf(hp // 2, wp // 2, 3, mc.backbone_width, 7)}
    stage_cfg = ([(1, 1), (2, 1), (2, 1), (1, 2)] if mc.output_stride == 16
                 else [(1, 1), (2, 1), (1, 2), (1, 4)])
    hh, ww = hp // 4, wp // 4
    cin, cur_h, cur_w = mc.backbone_width, hh, ww
    for stage, (n_blocks, (stride, _)) in enumerate(
            zip(mc.backbone_depths, stage_cfg)):
        ch = mc.backbone_width * (2 ** stage)
        fl = bf(cur_h, cur_w, cin, ch, stride, True)
        fl += (n_blocks - 1) * bf(cur_h // stride, cur_w // stride, ch * 4,
                                  ch, 1, False)
        out[f"stage{stage + 1}(x{n_blocks})"] = fl
        cur_h, cur_w = cur_h // stride, cur_w // stride
        cin = ch * 4
    ca = mc.aspp_channels
    out["aspp"] = (cf(cur_h, cur_w, cin, ca, 1)
                   + 3 * cf(cur_h, cur_w, cin, ca, 3)
                   + cf(1, 1, cin, ca, 1) + cf(cur_h, cur_w, 5 * ca, ca, 1))
    cd, cl = mc.decoder_channels, mc.low_level_channels
    out["decoder+emb"] = (cf(hh, ww, mc.backbone_width * 4, cl, 1)
                          + cf(hh, ww, ca + cl, cd, 3) + cf(hh, ww, cd, cd, 3)
                          + cf(hh, ww, cd, mc.embedding_dim, 1))
    return out


CONFIGS = {"flagship": ModelConfig(), "tiny": tiny_test_config().model,
           "os8": ModelConfig(output_stride=8)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_profile_encode_flops_equal_the_jax_scripts(name):
    jax_mod = _jax_profile_encode()
    mc = CONFIGS[name]
    for args in [(120, 216, 64, 256, 3), (30, 54, 1024, 2048, 1),
                 (17, 9, 3, 5, 7)]:
        assert profile_encode.conv_flops(*args) == jax_mod.conv_flops(*args)
    for args in [(120, 216, 64, 64, 1, True), (120, 216, 256, 128, 2, True),
                 (60, 108, 512, 128, 1, False), (31, 55, 1024, 512, 2, True)]:
        assert (profile_encode.bottleneck_flops(*args)
                == jax_mod.bottleneck_flops(*args))
    hp, wp = (480, 864) if name != "tiny" else (32, 48)
    got = profile_encode.stage_flops(mc, hp, wp)
    assert list(got) == profile_encode.stage_names(mc)
    assert got == _jax_stage_sums(jax_mod, mc, hp, wp)


# ------------------------------------------------- the stages, chained

@pytest.mark.parametrize("model_cfg", [
    tiny_test_config().model,
    ModelConfig(**{**tiny_test_config().model.__dict__,
                   "dtype": "bfloat16", "output_stride": 8})],
    ids=["tiny", "tiny-bf16-os8"])
def test_profile_encode_stages_chain_to_extract_features(model_cfg):
    """stem -> stage1..4 -> ASPP -> decoder, each the stage the profiler
    times, give `MANet.extract_features` bit for bit."""
    model = MANet(model_cfg, device="cpu", seed=3).eval()
    images = torch.randn((2, 32, 48, 3),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        calls, (feat, emb) = profile_encode.stage_calls(model, images)
        want_feat, want_emb = model.extract_features(images)
    assert [name for name, _, _ in calls] == profile_encode.stage_names(
        model_cfg)
    assert torch.equal(feat, want_feat) and torch.equal(emb, want_emb)


def test_profile_stages_chain_to_the_evaluators_first_round():
    """encode -> (the interaction head) -> prepare_ref -> matching -> sweep
    -> labels, each the stage the profiler times, give the Evaluator's
    first-round masks (`min_fused`) exactly."""
    cfg = tiny_test_config()
    model = MANet(cfg.model, device="cpu", seed=0)
    ev = Evaluator(cfg, model, device="cpu")
    ds = SyntheticDataset(image_size=cfg.eval.image_size, num_frames=4,
                          num_objects=2, num_sequences=1, scribble_sets=1)
    seq = ds.sequences()[0]
    images, n_obj = ds.images(seq), ds.num_objects(seq)
    scr = ds.initial_scribbles(seq, 0).to_json()
    assert annotated_frames(scr) == [0]        # the profiler's sweep order
    hw = images.shape[1:3]
    want = ev.run_round(ev.start_sequence(images, n_obj), scr, hw, n_obj)

    with torch.inference_mode():
        feat, emb = model.extract_features(torch.from_numpy(images))
        state = ev._init_state(feat, emb, images.shape[0], n_obj)
        o = state.prev_masks.shape[-1]
        obj_valid = torch.zeros(o)
        obj_valid[:n_obj + 1] = 1.0
        raster = scribbles2mask({"sequence": scr["sequence"],
                                 "scribbles": [scr["scribbles"][0]]}, hw)[0]
        head = ev._start_impl(state, torch.as_tensor(raster.astype(np.int8)),
                              0, obj_valid, None)
        bucketed = profile_stages.prepare(model, emb[0], head["ref_onehot"])
        for got, ref in zip(bucketed, head["bucketed"]):
            assert (got == ref if isinstance(got, int)
                    else torch.equal(got, ref))
        gm_pre = profile_stages.match(model, emb[1:], bucketed)
        probs = profile_stages.sweep(
            model, feat, emb, head["ref_emb"], head["ref_onehot"], gm_pre,
            head["gmap_mem"], head["head_fp"], head["head_mp"],
            head["int_mem"], obj_valid, head["int_probs"])
        probs = torch.cat([head["int_probs"][None], probs])
        masks = profile_stages.round_labels(probs, hw, hw,
                                            cfg.eval.mask_stride)
    assert masks.dtype == torch.int32
    np.testing.assert_array_equal(masks.numpy(), want)
