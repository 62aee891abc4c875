"""The PyTorch port stands alone: no JAX, no Flax, no pandas, nothing of the
JAX package, and no silent move to the CPU."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import cvpr2020_manet_tpu_torch
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.engine.propagate_batch import BatchPropagator
from cvpr2020_manet_tpu_torch.engine.streaming import StreamingIVOS
from cvpr2020_manet_tpu_torch.engine.train_stage1 import Trainer
from cvpr2020_manet_tpu_torch.engine.train_stage2 import Stage2Trainer
from cvpr2020_manet_tpu_torch.models import MANet

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "PIL",
             "cvpr2020_manet_tpu")
PKG_DIR = pathlib.Path(cvpr2020_manet_tpu_torch.__file__).parent


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_sources_import_nothing_forbidden():
    for path in sorted(PKG_DIR.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(PKG_DIR)} imports {bad}"


def test_tiny_round_in_fresh_process_loads_no_jax():
    """tests/conftest.py imports jax into this process, so the check runs
    in a subprocess: one tiny CPU session (int8 matching, uint8 frames),
    one tiny step of each trainer, a few streamed frames and one batch of
    propagation, then sys.modules is inspected."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from cvpr2020_manet_tpu_torch.config import tiny_test_config
        from cvpr2020_manet_tpu_torch.data import SyntheticDataset
        from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
        from cvpr2020_manet_tpu_torch.engine.train_stage1 import (
            Trainer, synthetic_batch)
        from cvpr2020_manet_tpu_torch.engine.train_stage2 import (
            Stage2Trainer)
        from cvpr2020_manet_tpu_torch.interactive.session import (
            InteractiveSession)
        from cvpr2020_manet_tpu_torch.models import MANet
        import cvpr2020_manet_tpu_torch.ops.trainable
        import cvpr2020_manet_tpu_torch.utils.checkpoint
        cfg = tiny_test_config()
        ds = SyntheticDataset(image_size=cfg.eval.image_size,
                              num_frames=cfg.eval.max_frames,
                              num_sequences=1, num_objects=2,
                              scribble_sets=1)
        model = MANet(cfg.model, device="cpu", matching_backend="int8")
        ev = Evaluator(cfg, model, device="cpu")
        ds.images_uint8 = lambda seq: (ds.images(seq) * 255).astype(
            np.uint8)
        summary = ev.run_session(InteractiveSession(ds, max_interactions=1))
        assert 0.0 <= summary["auc"] <= 1.0
        from cvpr2020_manet_tpu_torch.engine.propagate_batch import (
            BatchPropagator)
        from cvpr2020_manet_tpu_torch.engine.streaming import StreamingIVOS
        seq = ds.sequences()[0]
        u8 = ds.images_uint8(seq)
        s = StreamingIVOS(cfg, model, device="cpu")
        s.reset(2)
        s.observe(u8[0])
        s.correct(ds.initial_scribbles(seq, 0).to_json())
        assert s.observe_async(u8[1]).result().shape == u8.shape[1:3]
        labels = BatchPropagator(cfg, model, ingest="yuv420",
                                 device="cpu").propagate(
            u8[None], ds.gt_masks(seq)[None, 0, ::4, ::4], np.array([2]))
        assert labels.shape == (1, *u8.shape[:3])
        batch = synthetic_batch(cfg, np.random.default_rng(0))
        for trainer in (Trainer(cfg, device="cpu"),
                        Stage2Trainer(cfg, device="cpu")):
            assert np.isfinite(trainer.train_step(batch)["loss"])
        print(" ".join(sorted(sys.modules)))
    """)
    root = PKG_DIR.parent
    # one intra-op thread: the shapes are tiny, and parallel test workers
    # would oversubscribe the cores
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "cvpr2020_manet_tpu_torch" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no CUDA, an entry point that was not asked for the CPU raises
    instead of running there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    model = MANet(cfg.model, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Evaluator(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MANet(cfg.model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Evaluator(cfg, model, device="cuda")
    for trainer in (Trainer, Stage2Trainer):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer(cfg)
    for engine in (StreamingIVOS, BatchPropagator):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            engine(cfg, model)
        assert engine(cfg, model, device="cpu").device.type == "cpu"
    assert Evaluator(cfg, model, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("field,value", [("round_segments", 5),
                                         ("matching_memory", "stacked"),
                                         ("gmap_refresh", 0.5)])
def test_unported_eval_options_raise(field, value):
    import dataclasses
    cfg = tiny_test_config()
    cfg = dataclasses.replace(
        cfg, eval=dataclasses.replace(cfg.eval, **{field: value}))
    with pytest.raises(NotImplementedError):
        Evaluator(cfg, MANet(cfg.model, device="cpu"), device="cpu")
