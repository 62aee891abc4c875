"""Kernel 7's op (`manet::group_norm`) and the norms' call-site tail on the
CPU.

The norms take the call site's residual add and ReLU (`norm(x,
residual=, relu=)`); on the CPU that is the plain arithmetic of before,
bit for bit, and the op's CPU registration is the same arithmetic. The
dispatch rule sends bf16 calls with no autograd to record to the op, on
any device, so that a graph exported on the CPU holds it as one exported
on the card does. The launch planner's grid covers every row and plane in
chunks of whole 16-byte vectors and fills the card at the 1080p shapes;
merging the chunks' moments as the kernel does (Chan's formula, in split
order, counts from the grid) gives the row's moments.
"""

import io
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.models import layers
from cvpr2020_manet_tpu_torch.models.heads import ConvStack
from cvpr2020_manet_tpu_torch.models.layers import (
    BatchNorm, FrozenAffine, GroupNorm, LayerNorm, group_norm_takes_op)
from cvpr2020_manet_tpu_torch.models.resnet import Bottleneck
from cvpr2020_manet_tpu_torch.ops import group_norm_cuda as gn

H100_SMS = 132

# (N, C, H, W, groups): the sites of the three served paths, and odd ones
SITES = {
    "stem_1080p": (1, 64, 544, 960, 32),
    "layer3_1080p": (1, 1024, 68, 120, 32),
    "head_720p": (4, 256, 180, 320, 32),
    "low_level_480p": (1, 48, 120, 216, 16),
    "aspp_pooled": (1, 256, 1, 1, 1),
    "odd_hw": (3, 64, 37, 53, 32),
}


def _norm_input(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (3.0 + 2.0 * torch.randn(shape, generator=g)).to(dtype)


def _set_affine(norm, seed=1):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        norm.weight.copy_(1.0 + 0.5 * torch.randn(norm.weight.shape,
                                                  generator=g))
        norm.bias.copy_(0.5 * torch.randn(norm.bias.shape, generator=g))
    return norm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual,relu", [
    (False, False), (False, True), (True, False), (True, True)])
def test_group_norm_tail_on_cpu_is_the_plain_arithmetic(dtype, residual,
                                                        relu):
    norm = _set_affine(GroupNorm(4, 16))
    x = _norm_input((2, 16, 5, 7), dtype)
    r = _norm_input((2, 16, 5, 7), dtype, seed=2) if residual else None
    want = F.group_norm(x.float(), 4, norm.weight, norm.bias,
                        1e-6).to(dtype)
    if residual:
        want = want + r
    if relu:
        want = F.relu(want)
    with torch.no_grad():
        got = norm(x, residual=r, relu=relu)
        op = torch.ops.manet.group_norm(x, norm.weight, norm.bias, r, 4,
                                        1e-6, relu)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(op, want)


@pytest.mark.parametrize("make", [
    lambda: BatchNorm(6), lambda: LayerNorm(6),
    lambda: FrozenAffine(6, torch.bfloat16)])
def test_other_norms_take_the_same_tail(make):
    norm = make()
    x = _norm_input((2, 6, 3, 4), torch.bfloat16)
    r = _norm_input((2, 6, 3, 4), torch.bfloat16, seed=3)
    with torch.no_grad():
        want = F.relu(norm(x) + r)
        got = norm(x, residual=r, relu=True)
    assert torch.equal(got, want)


def _stand_in(device, dtype, requires_grad=False):
    """What the dispatch rule reads of a tensor, without a card."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 requires_grad=requires_grad)


def test_dispatch_rule():
    bf16, f32 = torch.bfloat16, torch.float32
    w = _stand_in("cuda", f32, requires_grad=True)
    b = _stand_in("cuda", f32)
    x = _stand_in("cuda", bf16)
    r = _stand_in("cuda", bf16)
    takes = group_norm_takes_op
    # the device does not enter: bf16 CPU calls take the op too
    assert takes(_stand_in("cpu", bf16), b, b, None, False)
    assert not takes(_stand_in("cuda", f32), b, b, None, False)
    assert not takes(_stand_in("cpu", f32), b, b, None, True)
    # a training call records a backward: the plain path
    assert not takes(x, w, b, None, True)
    assert not takes(_stand_in("cuda", bf16, requires_grad=True), b, b,
                     None, True)
    assert not takes(x, b, b, _stand_in("cuda", bf16, requires_grad=True),
                     True)
    assert takes(x, b, b, r, True)
    # the kernel adds a residual only before ReLU
    assert not takes(x, b, b, r, False)
    with torch.no_grad():
        assert takes(x, w, b, None, False)
        assert not takes(x, w, b, r, False)
    with torch.inference_mode():
        assert takes(x, w, b, r, True)
        assert takes(_stand_in("cpu", bf16), w, b, r, True)


def test_cpu_and_autograd_calls_take_f_group_norm(monkeypatch):
    """f32 calls and calls that record a backward (bf16 too) never reach
    the op, and the backward is F.group_norm's."""
    def refuse(*args, **kwargs):
        raise AssertionError("kernel 7's op called on the plain path")
    monkeypatch.setattr(layers, "group_norm", refuse)
    norm = _set_affine(GroupNorm(2, 8))
    x = _norm_input((2, 8, 4, 6), torch.float32).requires_grad_()
    r = _norm_input((2, 8, 4, 6), torch.float32, seed=4).requires_grad_()
    norm(x, residual=r, relu=True).square().sum().backward()
    x2 = x.detach().clone().requires_grad_()
    r2 = r.detach().clone().requires_grad_()
    w2 = norm.weight.detach().clone().requires_grad_()
    b2 = norm.bias.detach().clone().requires_grad_()
    F.relu(F.group_norm(x2, 2, w2, b2, 1e-6) + r2).square().sum().backward()
    for got, want in ((x.grad, x2.grad), (r.grad, r2.grad),
                      (norm.weight.grad, w2.grad), (norm.bias.grad, b2.grad)):
        assert torch.equal(got, want)
    with torch.no_grad():
        norm(x, relu=True)
    xb = x.detach().bfloat16().requires_grad_()
    assert norm(xb, relu=True).requires_grad


@pytest.mark.parametrize("residual,relu,takes", [
    (False, False, True), (False, True, True), (True, True, True),
    (True, False, False)])
def test_cpu_bf16_calls_take_the_op(monkeypatch, residual, relu, takes):
    """With no autograd to record, a bf16 call on the CPU goes to the op
    (its CPU registration) for each tail the kernel has, and gives the
    plain arithmetic; a residual without ReLU keeps the plain path."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return gn.group_norm(*args, **kwargs)
    monkeypatch.setattr(layers, "group_norm", counted)
    norm = _set_affine(GroupNorm(4, 16))
    x = _norm_input((2, 16, 5, 7), torch.bfloat16)
    r = _norm_input((2, 16, 5, 7), torch.bfloat16, seed=2) \
        if residual else None
    with torch.inference_mode():
        got = norm(x, residual=r, relu=relu)
    assert len(calls) == int(takes)
    assert torch.equal(got, gn.group_norm_plain(x, norm.weight, norm.bias,
                                                r, 4, 1e-6, relu))


def test_kernel_refuses_a_residual_without_relu():
    x = _norm_input((1, 8, 4, 4), torch.bfloat16)
    w, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="ReLU"):
        gn._check(x, w, b, x, 4, relu=False)
    # the other refusals still come after the tail's
    with pytest.raises(ValueError, match="unsupported device"):
        gn._check(x, w, b, x, 4, relu=True)


def test_bf16_ulps_reads_ulps_of_the_larger_magnitude():
    one = torch.tensor([1.0, -1.0, 2.0 ** -12, 3.0])
    ulp = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -17, 2.0 ** -6])
    # one ulp at 1 and 3 (bf16 keeps 8 bits); below ULP_FLOOR the ulp is
    # the floor's, 2^-17
    assert torch.equal(gn.bf16_ulps(one + ulp, one),
                       torch.tensor([1.0, 1.0, 1.0, 1.0]))
    # with a residual the normalized value's larger ulp counts
    got, want = torch.tensor([0.0]), torch.tensor([2.0 ** -7])
    assert float(gn.bf16_ulps(got, want)) == 128.0
    assert float(gn.bf16_ulps(got, want, torch.tensor([1.0]))) == 1.0


def _export_roundtrip(module, args):
    """torch.export under no_grad, saved and loaded again."""
    with torch.no_grad():
        ep = torch.export.export(module, args)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    return torch.export.load(buf)


@pytest.mark.parametrize("which", ["bottleneck", "bottleneck_shortcut",
                                   "conv_stack"])
def test_op_survives_export(monkeypatch, which):
    """A bf16 Bottleneck and ConvStack exported on the CPU hold
    `manet::group_norm` nodes (through the fake implementation) and run
    them through the CPU registration, equal to the module's plain
    path."""
    dt = torch.bfloat16
    g = torch.Generator().manual_seed(5)
    if which == "conv_stack":
        module, in_ch, n_norms = ConvStack(16, 16, 3, "gn", 4, dt), 16, 3
    else:
        shortcut = which == "bottleneck_shortcut"
        in_ch = 8 if shortcut else 32
        module = Bottleneck(in_ch, 8, norm="gn", gn_groups=4, dtype=dt)
        n_norms = 4 if shortcut else 3
    layers.init_weights(module, g)
    for m in module.modules():
        if isinstance(m, GroupNorm):
            _set_affine(m, seed=int(torch.randint(100, (1,), generator=g)))
    module.eval()
    x = _norm_input((2, in_ch, 6, 5), dt, seed=6)
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(layers, "group_norm_takes_op", lambda *a: False)
        want = module(x)
    ep = _export_roundtrip(module, (x,))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("manet.group_norm.default") == n_norms
    assert "aten.native_group_norm.default" not in targets
    assert "aten.relu.default" not in targets
    assert torch.equal(ep.module()(x), want)


@pytest.mark.parametrize("site", sorted(SITES))
def test_plan_covers_rows_and_planes_and_fills_the_card(site):
    n, c, h, w, groups = SITES[site]
    p = gn.plan(n, c, h * w, groups, H100_SMS)
    row_len, rows, planes = c // groups * h * w, n * groups, n * c
    for count, size, length, units in (
            (p.splits, p.chunk, row_len, rows),
            (p.plane_splits, p.plane_chunk, h * w, planes)):
        assert size % gn.VEC == 0
        assert (count - 1) * size < length <= count * size
        # where a row or plane holds enough whole chunks, at least 4
        # blocks an SM
        if length >= gn.MIN_CHUNK * -(-4 * H100_SMS // units):
            assert units * count >= 4 * H100_SMS
        if length <= gn.MIN_CHUNK:
            assert count == 1
    assert p.splits <= gn.MAX_SPLITS
    if site in ("stem_1080p", "layer3_1080p"):
        # 32 rows at 1080p: hundreds of statistics blocks, not 32
        assert rows * p.splits >= 512


def _chan(a, b):
    (na, ma, qa), (nb, mb, qb) = a, b
    n = na + nb
    d = mb - ma
    return n, ma + d * nb / n, qa + qb + d * d * na * nb / n


@pytest.mark.parametrize("site", ["low_level_480p", "odd_hw",
                                  "aspp_pooled"])
def test_chunk_moments_merge_to_the_row_moments(site):
    """The apply's merge: each statistics chunk's (mean, M2) merged in
    split order, counts from the grid, gives the row's mean and
    variance."""
    n, c, h, w, groups = SITES[site]
    p = gn.plan(n, c, h * w, groups, H100_SMS)
    x = _norm_input((n, c, h, w), torch.float64).reshape(n * groups, -1)
    row_len = x.shape[1]
    for row in x:
        acc = (0.0, 0.0, 0.0)
        for s in range(p.splits):
            part = row[s * p.chunk:(s + 1) * p.chunk]
            assert len(part) == min(p.chunk, row_len - s * p.chunk)
            mean = float(part.mean())
            acc = _chan(acc, (len(part), mean,
                              float(((part - mean) ** 2).sum())))
        assert acc[0] == row_len
        np.testing.assert_allclose(acc[1], float(row.mean()), rtol=1e-12)
        np.testing.assert_allclose(acc[2] / row_len,
                                   float(row.var(unbiased=False)),
                                   rtol=1e-10)


def test_kernel_is_registered_and_built_from_its_own_source():
    assert build.KERNELS["group_norm"] == "group_norm"
    assert build.LAUNCHES["group_norm"] >= 0
    with open(f"{build.CSRC_DIR}/group_norm.cu") as f:
        includes = [line.split()[1] for line in f
                    if line.startswith("#include")]
    # no CUTLASS or cute: the cold build stays short
    assert includes == ['"common.cuh"']


@pytest.mark.parametrize("entry", ["extract", "propagate"])
def test_bf16_graph_exported_on_cpu_holds_the_op(entry):
    """A bf16 serving entry exported on a host without a card holds every
    GroupNorm call of the live entry as a `manet::group_norm` node and no
    aten norm, so that on the card it launches kernel 7; it computes what
    the live entry does."""
    import dataclasses

    from cvpr2020_manet_tpu_torch.config import tiny_test_config
    from cvpr2020_manet_tpu_torch.models import MANet
    from cvpr2020_manet_tpu_torch.utils import export as ex
    cfg = tiny_test_config()
    model = MANet(dataclasses.replace(cfg.model, dtype="bfloat16"),
                  device="cpu", seed=0).eval()
    fn, args = ex.build_serving_fns(model, cfg.eval.image_size,
                                    cfg.model.max_objects,
                                    pad_to=cfg.eval.pad_to)[entry]
    calls = []
    hooks = [m.register_forward_hook(lambda *_: calls.append(1))
             for m in model.modules() if isinstance(m, GroupNorm)]
    try:
        with torch.no_grad():
            want = fn(*args)
    finally:
        for h in hooks:
            h.remove()
    ep = ex._export(model, fn, args)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert len(calls) > 0
    assert targets.count("manet.group_norm.default") == len(calls)
    assert not any("group_norm" in t and t.startswith("aten.")
                   for t in targets)
    got = ep.module()(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
