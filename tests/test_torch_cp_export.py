"""The context-parallel matching artifact (`utils/export.export_cp_matching`)
on the CPU: the port's counterpart of JAX's
`tests/test_export.py::test_sharded_cp_matching_exports_and_roundtrips`.

At JAX's shapes (q 64 x 16, k 128 x 16, onehot 128 x 3) over an
8-member mesh of CPU members, `cp_match_flat` (the allgather schedule)
exports through torch.export, saves with its mesh in the manifest, and
reloads onto a mesh of the same shape, where it must give the live call's
bits, and JAX's single-device `global_matching` on the same arrays to
ATOL (f32 sums in another order; the largest difference seen is 3.6e-7).
The onehot is one-hot with empty rows, as the engines give it: the
bucketed reference of kernel 1 (as of JAX's Pallas path) files each row
under one object, where JAX's test draws a 0/1 matrix that its jnp path
reads as multi-hot. The members share the CPU, so the graph is the split
on one device: one `manet::global_matching` node per member, no
copies. Another mesh shape and the int8 backend are refused, and so is
a loading mesh that puts members which share a device in the artifact on
two devices. The distinct-card layout (its copies) is in
`tests/test_torch_export_cuda.py`.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.ops.matching import global_matching
from cvpr2020_manet_tpu_torch.parallel.cp_matching import cp_match_flat
from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
from cvpr2020_manet_tpu_torch.utils import export as ex

ATOL = 1e-5
NODE = "manet.global_matching.default"


def _inputs(seed=0, nq=64, nk=128, c=16, o=3):
    """Queries that are noisy copies of reference rows (so that the
    distances do not all saturate), and a one-hot with empty rows (the
    engines' onehot, validity folded in)."""
    rng = np.random.default_rng(seed)
    k = (0.3 * rng.standard_normal((nk, c))).astype(np.float32)
    q = (k[rng.integers(0, nk, nq)]
         + 0.05 * rng.standard_normal((nq, c))).astype(np.float32)
    oh = np.eye(o, dtype=np.float32)[rng.integers(0, o, nk)]
    oh[rng.random(nk) < 0.3] = 0.0
    return q, k, oh


def _cpu_mesh(data=1, context=8):
    return create_mesh(data=data, context=context,
                       devices=["cpu"] * (data * context))


def _targets(ep):
    return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(path, manifest, mesh, numpy inputs) of the JAX test's artifact."""
    mesh = _cpu_mesh()
    arrays = _inputs()
    ep = ex.export_cp_matching(mesh, *map(torch.from_numpy, arrays))
    path = str(tmp_path_factory.mktemp("cp") / "cp.ivosx")
    manifest = ex.save_artifact(ep, path, mesh=mesh)
    return path, manifest, mesh, arrays


def test_roundtrip_equals_live_and_jax(artifact):
    """Reloaded onto a same-size mesh: the live call's bits, and JAX's
    single-device global matching to ATOL."""
    path, _, mesh, arrays = artifact
    loaded = ex.load_artifact(path, mesh=_cpu_mesh())
    args = [torch.from_numpy(a) for a in arrays]
    got = loaded(*args)
    assert got.shape == (64, 3) and got.dtype == torch.float32
    assert torch.equal(got, cp_match_flat(*args, mesh))
    want = np.asarray(global_matching(*map(jnp.asarray, arrays), None))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_graph_is_the_split_on_one_device(artifact):
    """Members that share the CPU: one global-matching node per member,
    no device copies."""
    path, _, _, _ = artifact
    targets = _targets(ex.load_artifact(path).exported)
    assert targets.count(NODE) == 8
    assert "aten._to_copy.default" not in targets
    assert "aten.amin.default" in targets


def test_manifest_records_the_mesh(artifact):
    path, manifest, _, _ = artifact
    assert manifest["mesh"] == {"data": 1, "context": 8}
    assert manifest["mesh_devices"] == [["cpu"] * 8]
    assert manifest["in_avals"] == [[[64, 16], "float32"],
                                    [[128, 16], "float32"],
                                    [[128, 3], "float32"]]
    assert manifest["out_avals"] == [[[64, 3], "float32"]]
    assert ex.load_artifact(path).manifest == manifest
    with pytest.raises(ValueError, match="reserved"):
        ex.save_artifact(ex.load_artifact(path).exported, path + ".x",
                         extra={"mesh": {"data": 1, "context": 8}},
                         mesh=_cpu_mesh())


@pytest.mark.parametrize("shape", [(1, 4), (2, 8), (2, 4)])
def test_refuses_another_mesh_shape(artifact, shape):
    path, _, _, _ = artifact
    with pytest.raises(ValueError, match="exported for a 1 x 8"):
        ex.load_artifact(path, mesh=_cpu_mesh(*shape))


def test_refuses_split_members_on_two_devices(artifact):
    """The artifact's members share the CPU, so its graph has no copies
    between them: a loading mesh that puts them on two devices is
    refused."""
    path, _, _, _ = artifact
    mesh = create_mesh(data=1, context=8, devices=["cpu"] * 4 + ["meta"] * 4)
    with pytest.raises(ValueError, match="must share one there too"):
        ex.load_artifact(path, mesh=mesh)


def test_refuses_int8_and_mesh_on_plain_artifact(artifact, tmp_path):
    path, _, mesh, arrays = artifact
    args = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError, match="int8"):
        ex.export_cp_matching(mesh, *args, matching_backend="int8")
    plain = str(tmp_path / "plain.ivosx")
    ex.save_artifact(ex.load_artifact(path).exported, plain)
    with pytest.raises(ValueError, match="not a mesh artifact"):
        ex.load_artifact(plain, mesh=mesh)
    with pytest.raises(ValueError, match="not both"):
        ex.load_artifact(path, device="cpu", mesh=mesh)


def test_data_rows_and_uneven_queries(tmp_path):
    """A 2 x 4 mesh (the data axis replicates: data row 0 computes), bf16
    queries against f32 keys (promoted, as in the model) and a query count
    that is no multiple of a tile: the artifact equals the live call."""
    mesh = _cpu_mesh(2, 4)
    q, k, oh = (torch.from_numpy(a) for a in _inputs(1, nq=50, nk=96, o=4))
    q = q.to(torch.bfloat16)
    ep = ex.export_cp_matching(mesh, q, k, oh)
    assert _targets(ep).count(NODE) == 4
    path = str(tmp_path / "cp24.ivosx")
    manifest = ex.save_artifact(ep, path, mesh=mesh)
    assert manifest["mesh"] == {"data": 2, "context": 4}
    loaded = ex.load_artifact(path, mesh=_cpu_mesh(2, 4))
    assert torch.equal(loaded(q, k, oh), cp_match_flat(q, k, oh, mesh))


def test_loads_in_fresh_process(artifact, tmp_path):
    """A process that imports only `utils.export` (and the mesh) loads the
    artifact and gives the live call's bits; it loads no JAX and no model
    code."""
    path, _, mesh, arrays = artifact
    np.savez(tmp_path / "in.npz", *arrays)
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        import torch
        from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
        from cvpr2020_manet_tpu_torch.utils import export
        a = export.load_artifact({path!r},
                                 mesh=create_mesh(1, 8, ["cpu"] * 8))
        z = np.load({str(tmp_path / "in.npz")!r})
        out = a(*(torch.from_numpy(z[f"arr_{{i}}"]) for i in range(3)))
        torch.save(out, {str(tmp_path / "out.pt")!r})
        print(json.dumps(sorted(m for m in sys.modules if m.startswith(
            ("jax", "cvpr2020_manet_tpu_torch.models")))))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    got = torch.load(tmp_path / "out.pt")
    assert torch.equal(got, cp_match_flat(
        *(torch.from_numpy(a) for a in arrays), mesh))
