"""Kernel 7 (`manet::group_norm`: GroupNorm with the residual add and
ReLU in its epilogue) vs its plain version, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a GPU. On a
machine with one (and no JAX) run them without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_group_norm_cuda.py

At every site shape of the served paths (the 1080p stem and layer 3, the
720p head over 4 clips, the low-level norm's 3 channels a group, the
ASPP's pooled 1 x 1 with one group) and an odd H * W, with each epilogue
the kernel has:

- the statistics pass's partials (each chunk's mean and sum of squared
  deviations) lie within f32 rounding of an f64 reference over the same
  chunk: 1e-5 of |mean| + std for the mean, 1e-5 relative for the sum
  (f32 sums of 32 values, then Chan merges some 15 deep: a few hundred
  roundings at most);
- the output is the plain version's (`F.group_norm` on x.float(), the bf16
  cast, the bf16 residual add, ReLU) to within one bf16 ulp on at least
  99.9% of the elements and two everywhere. Both round the same f32
  affine; only the statistics' summation order differs, by an absolute
  error of about |shift| * 2^-24 in the affine, so the ulp is taken
  (`group_norm_cuda.bf16_ulps`) at least at 2^-10, where that error is still a small part of it. With a
  residual the ulp is that of the larger of the output and the
  normalized value before the add: a normalized value one ulp apart
  stays one of its ulps apart in a sum that cancels it.
"""

import pytest
import torch

from cvpr2020_manet_tpu_torch.device import sm_count
from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.models.layers import GroupNorm
from cvpr2020_manet_tpu_torch.ops import group_norm_cuda as gn
from test_torch_group_norm import SITES

pytestmark = pytest.mark.cuda

EPS = 1e-6
TOL_MOMENTS = 1e-5
# the tails of the model's sites: the shortcut's norm, ReLU, norm3's
# residual then ReLU
EPILOGUES = {"plain": (False, False), "relu": (False, True),
             "residual_relu": (True, True)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, n, c, h, w, residual, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (3.0 + 2.0 * torch.randn((n, c, h, w), device=dev,
                                 generator=g)).bfloat16()
    weight = 1.0 + 0.5 * torch.randn(c, device=dev, generator=g)
    bias = 0.5 * torch.randn(c, device=dev, generator=g)
    r = torch.randn((n, c, h, w), device=dev, generator=g).bfloat16() \
        if residual else None
    return x, weight, bias, r


def check_partials(x: torch.Tensor, groups: int, partial: torch.Tensor,
                   grid: gn.Plan) -> None:
    rows = x.shape[0] * groups
    xr = x.double().reshape(rows, -1)
    p = partial.double().reshape(rows, grid.splits, 2)
    for s in range(grid.splits):
        part = xr[:, s * grid.chunk:(s + 1) * grid.chunk]
        mean = part.mean(1)
        m2 = (part - mean[:, None]).square().sum(1)
        std = (m2 / part.shape[1]).sqrt()
        assert ((p[:, s, 0] - mean).abs()
                <= TOL_MOMENTS * (mean.abs() + std)).all(), s
        assert ((p[:, s, 1] - m2).abs() <= TOL_MOMENTS * m2 + 1e-30).all(), s


@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("site", sorted(SITES))
def test_kernel_matches_plain_at_every_site(cuda, site, epilogue):
    n, c, h, w, groups = SITES[site]
    residual, relu = EPILOGUES[epilogue]
    x, weight, bias, r = _inputs(cuda, n, c, h, w, residual)
    before = build.LAUNCHES["group_norm"]
    got, partial = gn._launch(x, weight, bias, r, groups, EPS, relu)
    want = gn.group_norm_plain(x, weight, bias, r, groups, EPS, relu)
    torch.cuda.synchronize()
    assert build.LAUNCHES["group_norm"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    check_partials(x, groups, partial,
                   gn.plan(n, c, h * w, groups, sm_count(cuda)))
    normalized = gn.group_norm_plain(x, weight, bias, None, groups, EPS,
                                     False) if residual else None
    ulps = gn.bf16_ulps(got, want, normalized)
    assert float((ulps <= 1).float().mean()) >= 0.999
    assert float(ulps.max()) <= 2
    if relu:
        assert bool((got >= 0).all())


def test_residual_without_relu_is_refused(cuda):
    x, weight, bias, r = _inputs(cuda, 1, 64, 8, 8, True)
    before = build.LAUNCHES["group_norm"]
    with pytest.raises(ValueError, match="ReLU"):
        gn.group_norm(x, weight, bias, r, groups=32, eps=EPS, relu=False)
    assert build.LAUNCHES["group_norm"] == before


def test_misaligned_input_is_copied_first(cuda):
    """A view that starts off 16 bytes: the wrapper copies it, and the
    result is the aligned input's, bit for bit."""
    x, weight, bias, r = _inputs(cuda, 2, 48, 45, 81, True)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16
    want = gn.group_norm(x, weight, bias, r, groups=16, eps=EPS, relu=True)
    got = gn.group_norm(view, weight, bias, r, groups=16, eps=EPS, relu=True)
    assert torch.equal(got, want)


def test_module_takes_the_kernel_only_without_autograd(cuda):
    norm = GroupNorm(32, 256).to(cuda)
    x, weight, bias, r = _inputs(cuda, 2, 256, 30, 54, True)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    before = build.LAUNCHES["group_norm"]
    with torch.inference_mode():
        got = norm(x, residual=r, relu=True)
    assert build.LAUNCHES["group_norm"] == before + 1
    assert torch.equal(got, gn.group_norm(x, weight, bias, r, groups=32,
                                          eps=EPS, relu=True))
    # a training call records a backward: F.group_norm, no launch
    before = build.LAUNCHES["group_norm"]
    plain = norm(x, residual=r, relu=True)
    assert build.LAUNCHES["group_norm"] == before
    assert plain.requires_grad
    assert torch.equal(plain.detach(), gn.group_norm_plain(
        x, weight, bias, r, 32, EPS, True))


def test_kernel_replays_in_a_cuda_graph(cuda):
    """Two launches on the current stream, no synchronize, outputs and
    workspace from the caching allocator: a captured call replays to the
    eager result on new inputs."""
    x, weight, bias, r = _inputs(cuda, 1, 256, 60, 108, True)
    eager = gn.group_norm(x, weight, bias, r, groups=32, eps=EPS, relu=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gn.group_norm(x, weight, bias, r, groups=32, eps=EPS, relu=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gn.group_norm(x, weight, bias, r, groups=32, eps=EPS,
                            relu=True)
    x.mul_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, gn.group_norm(x, weight, bias, r, groups=32,
                                          eps=EPS, relu=True))
    assert not torch.equal(out, eager)
