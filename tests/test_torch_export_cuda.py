"""The `manet::*` custom ops and the serving artifacts on the card.

A CUDA kernel has no CPU mode, so these tests skip without a GPU. On a
machine with one (and no JAX) run them without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_export_cuda.py

Each custom op's CUDA registration calls the launcher the wrappers called
before the ops existed, on the same tensors, so the two give the same
bits, and each adds one launch. A tiny bundle exported on the card runs
its propagate entry through kernels 1 (or 3) and 2, and equals the live
module (the export CLI's --check, 1e-5). A bundle exported on the CPU and
moved to the card with `move_to_device_pass` launches the kernels too,
and agrees with the same bundle on the CPU to 1e-3, the tolerance
chip_smoke.py holds a tiny f32 round to between the card and the CPU
(cuDNN's convolution algorithms and the kernels' sums run in other
orders; TF32 is off).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvpr2020_manet_tpu_torch.kernels import build
from cvpr2020_manet_tpu_torch.ops.global_matching_cuda import (
    _launch, _launch_int8, global_matching_prepared,
    global_matching_prepared_int8, prepare_ref, prepare_ref_int8)
from cvpr2020_manet_tpu_torch.ops.local_matching_cuda import (
    _launch as local_launch, local_matching_prepared, prepare_local)
from cvpr2020_manet_tpu_torch.utils import export as ex
from cvpr2020_manet_tpu_torch.utils import export_cli

pytestmark = pytest.mark.cuda

TOL_CARD_VS_CPU = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _count(name, fn):
    before = build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_global_ops_equal_launchers(cuda, dtype):
    rng = np.random.default_rng(0)
    k = torch.tensor(0.3 * rng.normal(size=(3000, 100)), dtype=dtype,
                     device=cuda)
    q = torch.tensor(0.3 * rng.normal(size=(1000, 100)), dtype=dtype,
                     device=cuda)
    onehot = torch.tensor(np.eye(4)[rng.integers(0, 3, size=3000)],
                          dtype=torch.float32, device=cuda)
    b = prepare_ref(k, onehot)
    want = _count("global_matching", lambda: _launch(q, b, argmin=False)[0])
    got = _count("global_matching",
                 lambda: torch.ops.manet.global_matching(q, *b))
    assert got.shape == (1000, 4) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(_count("global_matching",
                              lambda: global_matching_prepared(q, b)), want)
    if dtype == torch.bfloat16:
        b8 = prepare_ref_int8(k, onehot)
        want = _count("global_matching_int8", lambda: _launch_int8(q, b8))
        got = _count("global_matching_int8",
                     lambda: torch.ops.manet.global_matching_int8(q, *b8))
        assert got.shape == (1000, 4) and got.dtype == torch.float32
        assert torch.equal(got, want)
        assert torch.equal(_count(
            "global_matching_int8",
            lambda: global_matching_prepared_int8(q, b8)), want)


def test_local_op_equals_launcher(cuda):
    rng = np.random.default_rng(1)
    k = torch.tensor(0.3 * rng.normal(size=(60, 108, 100)),
                     dtype=torch.float32, device=cuda)
    q = torch.roll(k, (1, -1), (0, 1)) + 0.02 * torch.randn(
        k.shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    oh = torch.tensor(np.eye(4)[rng.integers(0, 4, size=(60, 108))],
                      dtype=torch.float32, device=cuda)
    inputs = prepare_local(q, k, oh)
    want = _count("local_matching",
                  lambda: local_launch(*inputs, 15, argmin=False)[0])
    got = _count("local_matching",
                 lambda: torch.ops.manet.local_matching(*inputs, 15))
    assert got.shape == (60, 108, 4) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(_count(
        "local_matching", lambda: local_matching_prepared(*inputs, 15)), want)


def _propagate_args(bundle, device, seed=0):
    """Random inputs of the propagate entry, from its manifest."""
    g = torch.Generator().manual_seed(seed)
    args = []
    for shape, dtype in bundle["propagate"].manifest["in_avals"]:
        args.append(torch.randn(shape, generator=g).to(
            device=device, dtype=getattr(torch, dtype)))
    return args


@pytest.mark.parametrize("backend,kernel", [
    ("auto", "global_matching"), ("int8", "global_matching_int8")])
def test_tiny_bundle_on_card_launches_kernels(cuda, tmp_path, backend,
                                              kernel):
    path = str(tmp_path / "b.ivosx")
    export_cli.main(["--out", path, "--tiny", "--bundle", "--check",
                     "--device", "cuda", "--matching_backend", backend])
    bundle = ex.load_bundle(path)
    assert bundle.manifest["entries"]["propagate"]["device"] == "cuda"
    args = _propagate_args(bundle, cuda)
    build.reset_launches()
    probs, gmap = bundle["propagate"](*args)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        kernel: 1, "local_matching": 1}
    assert probs.is_cuda and torch.isfinite(probs).all()


def test_cpu_bundle_moved_to_card(cuda, tmp_path):
    """The build host has no card: a bundle exported on the CPU and
    loaded with device='cuda' (move_to_device_pass) serves on the card
    through the kernels."""
    path = str(tmp_path / "cpu.ivosx")
    export_cli.main(["--out", path, "--tiny", "--bundle", "--device", "cpu"])
    on_cpu = ex.load_bundle(path)
    on_card = ex.load_bundle(path, device="cuda")
    assert on_card["propagate"].device.type == "cuda"
    args = _propagate_args(on_cpu, "cpu")
    args[3] = F.one_hot(args[3].argmax(-1), args[3].shape[-1]).float()
    want = on_cpu["propagate"](*args)
    build.reset_launches()
    got = on_card["propagate"](*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        "global_matching": 1, "local_matching": 1}
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=TOL_CARD_VS_CPU)
    image = torch.randint(0, 256, on_cpu["extract"].manifest["in_avals"][0][0],
                          dtype=torch.uint8)
    for g, w in zip(on_card["extract"](image.to(cuda)),
                    on_cpu["extract"](image)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=TOL_CARD_VS_CPU)


def _cp_inputs(device, nq=3000, nk=2048, c=100, o=4, seed=0):
    rng = np.random.default_rng(seed)
    k = 0.3 * rng.normal(size=(nk, c))
    q = k[rng.integers(0, nk, nq)] + 0.05 * rng.normal(size=(nq, c))
    oh = np.eye(o)[rng.integers(0, o, nk)]
    oh[rng.random(nk) < 0.3] = 0.0
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (q, k, oh)]


def _cp_roundtrip(path, mesh, args, members):
    """Export cp_match_flat over `mesh`, save, load onto a mesh of the same
    members: bit-equal to the live call, one kernel-1 launch a member."""
    from cvpr2020_manet_tpu_torch.parallel.cp_matching import cp_match_flat
    from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
    ep = ex.export_cp_matching(mesh, *args)
    manifest = ex.save_artifact(ep, path, mesh=mesh)
    assert manifest["mesh"] == {"data": 1, "context": len(members)}
    loaded = ex.load_artifact(path, mesh=create_mesh(1, len(members),
                                                     members))
    build.reset_launches()
    got = loaded(*args)
    torch.cuda.synchronize()
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        "global_matching": len(members)}
    assert torch.equal(got, cp_match_flat(*args, mesh))
    return loaded


def test_cp_artifact_on_one_card(cuda, tmp_path):
    """Four members on one card: the split on one device (4 kernel-1
    nodes, no copies), bit-equal to the live call after a round trip."""
    from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
    members = [torch.device("cuda", torch.cuda.current_device())] * 4
    loaded = _cp_roundtrip(str(tmp_path / "cp.ivosx"),
                           create_mesh(1, 4, members), _cp_inputs(cuda),
                           members)
    targets = [str(n.target) for n in loaded.exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count("manet.global_matching.default") == 4
    assert "aten._to_copy.default" not in targets


def test_cp_artifact_from_cpu_moved_to_card(cuda, tmp_path):
    """Exported over 4 CPU members, loaded onto 4 members of the card: the
    members map to the card, the kernels run, and the result agrees with
    the CPU artifact to the kernel's f32 tolerance."""
    from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
    args = _cp_inputs("cpu", nq=500, nk=512)
    path = str(tmp_path / "cp_cpu.ivosx")
    ex.save_artifact(ex.export_cp_matching(
        create_mesh(1, 4, ["cpu"] * 4), *args), path,
        mesh=create_mesh(1, 4, ["cpu"] * 4))
    want = ex.load_artifact(path)(*args)
    on_card = ex.load_artifact(path, mesh=create_mesh(1, 4, [cuda] * 4))
    build.reset_launches()
    got = on_card(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert build.LAUNCHES["global_matching"] == 4
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_cp_artifact_on_distinct_cards(cuda, tmp_path):
    """Members on distinct cards: the graph holds the copies to and from
    them, and a round trip is bit-equal to the live call."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards: members on distinct cards")
    from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
    members = [torch.device("cuda", i) for i in range(n)]
    loaded = _cp_roundtrip(str(tmp_path / "cp_n.ivosx"),
                           create_mesh(1, n, members),
                           _cp_inputs(members[0], nk=512 * n), members)
    copies = [n_ for n_ in loaded.exported.graph.nodes
              if n_.op == "call_function" and "device" in n_.kwargs]
    assert {str(n_.kwargs["device"]) for n_ in copies} >= {
        str(d) for d in members[1:]}
