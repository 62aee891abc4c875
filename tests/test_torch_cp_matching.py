"""The port's context-parallel matching vs the JAX package's, on the CPU.

The port's mesh members are CPU devices here (`create_mesh(data, context,
devices=[cpu] * n)`); JAX's are the 8 virtual CPU devices tests/conftest.py gives it.
Both sides get the same numpy inputs: queries that are noisy copies of
reference rows (so that the normalized distances do not all saturate),
and a `valid` mask with holes. The port's three schedules (allgather,
ring, ring_kernel) are held against JAX's `allgather` and `ring`
schedules in process, and the plain ring-kernel schedule against JAX's
`ring_pallas` in interpret mode, which runs in a subprocess per call as
tests/test_ring_matching.py does. Both sides take the same f32 products
and sum them in another order: atol 1e-5.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu.parallel.cp_matching import (
    context_parallel_matching as jax_cp_matching)
from cvpr2020_manet_tpu.parallel.mesh import create_mesh as jax_mesh
from cvpr2020_manet_tpu_torch.parallel.cp_matching import (
    check_cp_engine, context_parallel_matching, cp_match_flat)
from cvpr2020_manet_tpu_torch.parallel.mesh import (
    create_mesh, shard_context)
from cvpr2020_manet_tpu_torch.parallel.ring import ring_rotate

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
ATOL = 1e-5


def _inputs(nq=64, nk=256, c=16, o=3, seed=0):
    rng = np.random.default_rng(seed)
    k = (0.3 * rng.normal(size=(nk, c))).astype(np.float32)
    q = (k[rng.integers(0, nk, size=nq)]
         + 0.05 * rng.normal(size=(nq, c))).astype(np.float32)
    oh = np.eye(o, dtype=np.float32)[rng.integers(0, o, size=nk)]
    valid = (rng.random(nk) > 0.4).astype(np.float32)
    return q, k, oh, valid


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_mesh_shapes_and_sharding():
    mesh = create_mesh(data=2, context=4, devices=[CPU] * 8)
    assert mesh.shape == {"data": 2, "context": 4}
    assert mesh.context_devices == [CPU] * 4
    assert create_mesh(context=2, devices=[CPU] * 6).shape == {
        "data": 3, "context": 2}
    x = torch.arange(24.0).reshape(12, 2)
    shards = shard_context(x, mesh)
    assert [s.shape for s in shards] == [(3, 2)] * 4
    assert torch.equal(torch.cat(shards), x)
    with pytest.raises(ValueError):
        shard_context(x[:10], mesh)              # 10 rows over 4 members
    with pytest.raises(ValueError):
        create_mesh(data=3, context=4, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        create_mesh(context=3, devices=[CPU] * 8)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ring_visits_every_shard_once(n):
    """At step s member m holds the shard that started on member
    (m - s) mod n, unchanged: every member sees every shard exactly once,
    through the two-slot rotation."""
    shards = [(torch.full((5, 3), float(m)), torch.arange(4) + 10 * m)
              for m in range(n)]
    seen = []

    def step(m, s, arrays):
        a, b = arrays
        origin = int(a[0, 0])
        assert torch.equal(a, shards[origin][0])
        assert torch.equal(b, shards[origin][1])
        seen.append((m, s, origin))

    ring_rotate([CPU] * n, shards, step)
    assert sorted(seen) == [(m, s, (m - s) % n)
                            for m in range(n) for s in range(n)]
    for m in range(n):                           # the shards stay intact
        assert torch.equal(shards[m][0], torch.full((5, 3), float(m)))


@pytest.mark.parametrize("data,ctx", [(1, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("schedule", ["allgather", "ring", "ring_kernel"])
def test_cp_matching_matches_jax(schedule, data, ctx):
    q, k, oh, valid = _inputs()
    jmesh = jax_mesh(data=data, context=ctx)
    args = [jnp.asarray(a) for a in (q, k, oh, valid)]
    want = {s: np.asarray(jax_cp_matching(*args, jmesh, schedule=s))
            for s in ("allgather", "ring")}
    mesh = create_mesh(data=data, context=ctx, devices=[CPU] * (data * ctx))
    got = context_parallel_matching(*_torch(q, k, oh, valid), mesh,
                                    schedule=schedule).numpy()
    assert got.shape == (64, 3) and got.dtype == np.float32
    assert (want["allgather"] < 0.9).mean() > 0.3     # not all saturated
    for s, w in want.items():
        np.testing.assert_allclose(got, w, atol=ATOL, err_msg=s)


def test_cp_match_flat_matches_single_shard():
    """The engines' call (allgather, all rows valid, validity folded into
    the onehot) equals the same matching on one member."""
    q, k, oh, valid = _torch(*_inputs())
    gated = oh * valid[:, None]
    one = cp_match_flat(q, k, gated, create_mesh(devices=[CPU]))
    four = cp_match_flat(q, k, gated,
                         create_mesh(data=1, context=4, devices=[CPU] * 4))
    torch.testing.assert_close(four, one, rtol=0, atol=ATOL)


def test_cp_matching_refuses_int8_and_bad_arguments():
    """An engine's cp_mesh check refuses the int8 backend and members of
    another device type than the engine's; the call refuses an unknown
    schedule and rows that do not split over the members."""
    q, k, oh, valid = _torch(*_inputs())
    mesh = create_mesh(data=1, context=4, devices=[CPU] * 4)
    check_cp_engine(mesh, CPU, "auto", "eval")
    with pytest.raises(ValueError, match="int8"):
        check_cp_engine(mesh, CPU, "int8", "eval")
    with pytest.raises(ValueError, match="members"):   # card engine, CPU ring
        check_cp_engine(mesh, torch.device("cuda"), "auto", "streaming")
    with pytest.raises(ValueError, match="members"):   # one member elsewhere
        check_cp_engine(create_mesh(data=1, context=2,
                                    devices=[CPU, torch.device("cuda", 0)]),
                        CPU, "auto", "eval")
    with pytest.raises(ValueError):
        context_parallel_matching(q, k, oh, valid, mesh, schedule="tree")
    with pytest.raises(ValueError):                  # 255 rows over 4
        context_parallel_matching(q, k[:255], oh[:255], valid[:255], mesh)


_JAX_RING = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np, jax.numpy as jnp
from cvpr2020_manet_tpu.parallel.cp_matching import context_parallel_matching
from cvpr2020_manet_tpu.parallel.mesh import create_mesh
ctx, dtype, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
d = np.load(path + ".npz")
out = context_parallel_matching(
    jnp.asarray(d["q"], dtype), jnp.asarray(d["k"]), jnp.asarray(d["oh"]),
    jnp.asarray(d["valid"]), create_mesh(data=1, context=ctx),
    schedule="ring_pallas", backend="pallas_interpret")
np.save(path + "_out.npy", np.asarray(out))
print("RING OK")
"""


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ctx", [2, 4])
def test_ring_kernel_plain_matches_jax_ring_pallas(tmp_path, ctx, dtype):
    """The plain ring-kernel schedule (kernel 6's plain version, driven by
    the ring rotation) against JAX's RDMA ring kernel in interpret mode.
    A bf16 query is promoted to f32 on both sides (the keys are f32)."""
    q, k, oh, valid = _inputs(nk=512)
    path = str(tmp_path / "ring")
    np.savez(path + ".npz", q=q, k=k, oh=oh, valid=valid)
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    proc = subprocess.run([sys.executable, "-c", _JAX_RING, str(ctx), dtype,
                           path], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=540)
    assert proc.returncode == 0 and "RING OK" in proc.stdout, \
        proc.stderr[-2000:]
    want = np.load(path + "_out.npy")
    tq, tk, toh, tvalid = _torch(q, k, oh, valid)
    tq = tq.to(getattr(torch, dtype))
    got = context_parallel_matching(
        tq, tk, toh, tvalid,
        create_mesh(data=1, context=ctx, devices=[CPU] * ctx),
        schedule="ring_kernel").numpy()
    assert (want < 0.9).mean() > 0.3
    np.testing.assert_allclose(got, want, atol=ATOL)
