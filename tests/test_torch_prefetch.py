"""`engine/prefetch.prefetch_to_device`: order and values, plain copies on
the CPU; on the card (marker `cuda`, skips without one; run there with
`python -m pytest --noconftest -m cuda tests/test_torch_prefetch.py`) the
pinned non-blocking copies on the side stream, read on the consumer's
stream right away."""

import numpy as np
import pytest
import torch

from cvpr2020_manet_tpu_torch.engine.prefetch import prefetch_to_device


def batches(n, shape=(2, 3, 8, 8, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.integers(0, 256, shape, dtype=np.uint8),
             "labels": rng.integers(0, 3, shape[:-1], dtype=np.uint8),
             "obj_valid": rng.random((shape[0], 3)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("size", [1, 2, 5])
@pytest.mark.parametrize("n", [0, 1, 4])
def test_order_and_values_on_cpu(size, n):
    """Every batch once, in order, as CPU tensors of its own dtype, also
    when the iterator is shorter than the buffer."""
    want = batches(n)
    got = list(prefetch_to_device(iter(want), "cpu", size=size))
    assert len(got) == n
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            assert isinstance(g[key], torch.Tensor)
            assert g[key].device.type == "cpu"
            np.testing.assert_array_equal(g[key].numpy(), value)


def test_prefetch_runs_ahead():
    """With size 2 the next batch is taken from the iterator before the
    current one is handed out."""
    taken = []

    def source():
        for i, b in enumerate(batches(3)):
            taken.append(i)
            yield b
    it = prefetch_to_device(source(), "cpu", size=2)
    next(it)
    assert taken == [0, 1]


@pytest.mark.parametrize("size", [0, -1])
def test_size_below_one_raises(size):
    with pytest.raises(ValueError, match="size"):
        prefetch_to_device(iter(batches(1)), "cpu", size=size)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the side-stream copies run there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_side_stream_copies_on_cuda(cuda):
    """Large batches (64 MiB of images each), summed on the consumer's
    stream as soon as they are yielded: the sums equal the host's, so the
    consumer waited for each copy; each tensor is on the card."""
    want = batches(4, shape=(8, 8, 416, 416, 3), seed=1)
    sums = []
    for got in prefetch_to_device(iter(want), cuda, size=2):
        assert all(t.device.type == "cuda" for t in got.values())
        sums.append({k: t.double().sum() for k, t in got.items()})
    torch.cuda.synchronize()
    for s, w in zip(sums, want):
        for key, value in w.items():
            assert s[key].item() == pytest.approx(
                float(value.astype(np.float64).sum()), rel=1e-12)
