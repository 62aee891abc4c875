"""The PyTorch port stands alone: no JAX, no Flax, no pandas, nothing of the
JAX package, and no silent move to the CPU."""

import ast
import glob
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
from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "PIL",
             "cvpr2020_manet_tpu", "davisinteractive")
PKG_DIR = pathlib.Path(cvpr2020_manet_tpu_torch.__file__).parent


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_sources_import_nothing_forbidden():
    """Every module of the port, and chip_smoke.py."""
    for path in [*sorted(PKG_DIR.rglob("*.py")),
                 PKG_DIR.parent / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.name} imports {bad}"


def test_tiny_round_in_fresh_process_loads_no_jax():
    """tests/conftest.py imports jax into this process, so the check runs
    in a subprocess: one tiny CPU session (int8 matching, uint8 frames),
    one tiny step of each trainer and of the context-parallel trainer, a
    few streamed frames, one batch of propagation, the three
    context-parallel schedules on CPU members, the distributed layer and
    a backbone load into a 'frozen' model, then sys.modules is
    inspected."""
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
        import cvpr2020_manet_tpu_torch.ops.ring_matching_cuda
        import cvpr2020_manet_tpu_torch.parallel.ring
        import cvpr2020_manet_tpu_torch.utils.checkpoint
        from cvpr2020_manet_tpu_torch.parallel.cp_matching import (
            context_parallel_matching)
        from cvpr2020_manet_tpu_torch.parallel.mesh import create_mesh
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
        import torch
        mesh = create_mesh(data=1, context=2, devices=["cpu", "cpu"])
        q, k = torch.randn(8, 16), torch.randn(32, 16)
        oh, valid = torch.eye(3)[torch.arange(32) % 3], torch.ones(32)
        for schedule in ("allgather", "ring", "ring_kernel"):
            assert context_parallel_matching(q, k, oh, valid, mesh,
                                             schedule).shape == (8, 3)
        labels = BatchPropagator(cfg, model, ingest="yuv420",
                                 device="cpu").propagate(
            u8[None], ds.gt_masks(seq)[None, 0, ::4, ::4], np.array([2]))
        assert labels.shape == (1, *u8.shape[:3])
        batch = synthetic_batch(cfg, np.random.default_rng(0))
        for trainer in (Trainer(cfg, device="cpu"),
                        Stage2Trainer(cfg, device="cpu")):
            assert np.isfinite(trainer.train_step(batch)["loss"])
        import dataclasses
        import cvpr2020_manet_tpu_torch.parallel.distributed
        from cvpr2020_manet_tpu_torch.engine.train_stage1 import (
            make_cp_train_step)
        from cvpr2020_manet_tpu_torch.utils.pretrained import (
            load_backbone_into)
        trainer = Trainer(cfg, device="cpu")
        step = make_cp_train_step(trainer.model, cfg, mesh)
        assert np.isfinite(step(trainer.state, batch)["loss"])
        frozen = MANet(dataclasses.replace(cfg.model, norm="frozen"),
                       device="cpu")
        load_backbone_into(frozen, frozen.encoder.backbone.state_dict())
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


def test_davis_cli_in_fresh_process_loads_no_jax(davis_root, tmp_path):
    """A fresh process decodes a JPEG and a PNG of the DAVIS tree, runs the
    DAVIS CLI on it (the device resolved to the CPU) with a report, saved
    masks and --resume, and completes a round trip with the evaluation
    service; then sys.modules holds nothing of JAX, pandas or PIL."""
    code = textwrap.dedent(f"""
        import glob, json, sys
        import torch
        from cvpr2020_manet_tpu_torch.data.davis import DavisEvalDataset
        from cvpr2020_manet_tpu_torch.engine import eval_davis
        from cvpr2020_manet_tpu_torch.interactive.service import (
            RemoteSession, serve)
        from cvpr2020_manet_tpu_torch.native.image import read_jpeg
        from cvpr2020_manet_tpu_torch.utils.colormap import load_indexed_png
        root = {str(davis_root)!r}
        jpg = sorted(glob.glob(root + "/JPEGImages/480p/seq_a/*.jpg"))[0]
        png = sorted(glob.glob(root + "/Annotations/480p/seq_a/*.png"))[0]
        assert read_jpeg(jpg).shape == (64, 96, 3)
        assert load_indexed_png(png).max() == 2
        eval_davis.resolve_device = lambda device=None: torch.device("cpu")
        eval_davis.main(["--davis_root", root, "--tiny", "--rounds", "1",
                         "--scribble_sets", "1", "--max_frames", "4",
                         "--image_size", "64", "96", "--resume",
                         "--report", {str(tmp_path / "r.csv")!r},
                         "--save_masks", {str(tmp_path / "m")!r}])
        ds = DavisEvalDataset(root, scribble_sets=1)
        srv, thread = serve(ds)
        sess = RemoteSession(
            f"http://127.0.0.1:{{srv.server_address[1]}}",
            max_nb_interactions=1)
        while sess.next():
            seq, _, _ = sess.get_scribbles()
            sess.submit_masks(ds.gt_masks(seq))
        assert len(sess.get_report()) == 2 * 2 * 4
        srv.shutdown()
        print(" ".join(sorted(sys.modules)))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG_DIR.parent,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "cvpr2020_manet_tpu_torch.engine.eval_davis" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad
    assert len(glob.glob(str(tmp_path / "m" / "*" / "*" / "*.png"))) == 8


def test_training_data_in_fresh_process_loads_no_jax(davis_root, tmp_path):
    """A fresh process samples DAVIS and YouTube-VOS clips through the
    training loader with one spawned worker, prefetches them and runs a
    tiny uint8 stage-1 step (the device resolved to the CPU); neither the
    process nor the worker holds anything of JAX, pandas or PIL."""
    tests = pathlib.Path(__file__).parent
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(tests)!r})
        import numpy as np
        from _torch_davis_tree import write_ytvos_tree
        from _torch_loader_probe import ModulesProbe
        from cvpr2020_manet_tpu_torch.config import tiny_test_config
        from cvpr2020_manet_tpu_torch.data.davis import DavisTrainDataset
        from cvpr2020_manet_tpu_torch.data.grain_pipeline import (
            iterate, make_train_iterator)
        from cvpr2020_manet_tpu_torch.data.ytvos import YTVOSDataset
        from cvpr2020_manet_tpu_torch.engine.prefetch import (
            prefetch_to_device)
        from cvpr2020_manet_tpu_torch.engine.train_stage1 import Trainer
        cfg = tiny_test_config()
        ds = DavisTrainDataset({str(davis_root)!r}, cfg, emit_uint8=True)
        it = iterate(ModulesProbe(ds, 2, 0, 100, 0, 1), 1)
        worker = next(it).pop("modules")
        it.close()
        yt = {str(tmp_path / "yt")!r}
        write_ytvos_tree(yt, (64, 96), [("v1", 4, 2, 0)])
        batches = make_train_iterator("", cfg, num_workers=0,
                                      emit_uint8=True,
                                      adapter=YTVOSDataset(yt))
        batch = next(prefetch_to_device(batches, "cpu"))
        assert np.isfinite(Trainer(cfg, device="cpu").train_step(
            batch)["loss"])
        print(" ".join(sorted(sys.modules)))
        print(worker)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG_DIR.parent,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    parent, worker = (line.split() for line in
                      out.stdout.strip().splitlines()[-2:])
    assert "cvpr2020_manet_tpu_torch.data.grain_pipeline" in parent
    assert "cvpr2020_manet_tpu_torch.data.davis" in worker
    for loaded in (parent, worker):
        bad = [m for m in loaded if _forbidden(m)]
        assert not bad, bad


def test_train_eval_entry_points_in_fresh_process_load_no_jax(tmp_path):
    """A fresh process imports the utilities (meters, profiling,
    visualize), the fake DAVIS writer, both train-eval entry points and the
    rehearsal orchestrator, and runs the flagship entry point at the tiny
    config on the CPU for one stage-1 step and one eval round; then
    sys.modules holds nothing of JAX, pandas or PIL."""
    code = textwrap.dedent(f"""
        import sys
        import cvpr2020_manet_tpu_torch.data.fake_davis
        import cvpr2020_manet_tpu_torch.rehearse_eval_modes
        import cvpr2020_manet_tpu_torch.train_eval_synthetic
        import cvpr2020_manet_tpu_torch.utils.meters
        import cvpr2020_manet_tpu_torch.utils.profiling
        import cvpr2020_manet_tpu_torch.utils.visualize
        from cvpr2020_manet_tpu_torch import train_eval_flagship
        rc = train_eval_flagship.main([
            "--tiny", "--device", "cpu", "--steps1", "1", "--steps2", "0",
            "--frames", "4", "--objects", "2", "--sequences", "1",
            "--sets", "1", "--rounds", "1",
            "--release", {str(tmp_path / "rel")!r}])
        assert rc == 1                    # one round: no later round
        print(" ".join(sorted(sys.modules)))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG_DIR.parent,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.strip().splitlines()[-1].split()
    for module in ("train_eval_flagship", "rehearse_eval_modes",
                   "data.fake_davis", "utils.visualize"):
        assert f"cvpr2020_manet_tpu_torch.{module}" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def test_davisinteractive_shim_in_fresh_process_loads_no_jax(davis_root,
                                                             tmp_path):
    """A fresh process imports every module of the port's davisinteractive
    shim, reads the DAVIS tree through its `Davis` (frames through the
    port's JPEG decoder), scores and draws with it, and runs the
    reference-style script on its synthetic task (the device resolved to
    the CPU); then sys.modules holds nothing of JAX, pandas, PIL or the
    top-level `davisinteractive`."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        import cvpr2020_manet_tpu_torch.davisinteractive.evaluation.service
        import cvpr2020_manet_tpu_torch.davisinteractive.logging
        import cvpr2020_manet_tpu_torch.davisinteractive.storage
        import cvpr2020_manet_tpu_torch.davisinteractive.utils
        from cvpr2020_manet_tpu_torch.davisinteractive.dataset import Davis
        from cvpr2020_manet_tpu_torch.davisinteractive.metrics import (
            batched_f_measure)
        from cvpr2020_manet_tpu_torch.davisinteractive.robot import (
            InteractiveScribblesRobot)
        from cvpr2020_manet_tpu_torch.davisinteractive.utils.visualization \
            import draw_scribble
        from cvpr2020_manet_tpu_torch import reference_style_eval
        from cvpr2020_manet_tpu_torch.engine import eval_davis
        davis = Davis({str(davis_root)!r})
        images = davis.load_images("seq_a")
        gt = davis.load_annotations("seq_a")
        assert images.shape == (4, 64, 96, 3)
        assert batched_f_measure(gt, gt).tolist() == [1.0] * 4
        pay = InteractiveScribblesRobot().interact("seq_a", 0 * gt, gt)
        assert draw_scribble(images[0], davis.load_scribble("seq_a", 1), 0,
                             output_size=(32, 48)).shape == (32, 48, 3)
        eval_davis.resolve_device = lambda device=None: torch.device("cpu")
        reference_style_eval.main(["--synthetic", "--rounds", "1",
                                   "--report", {str(tmp_path / "r.csv")!r}])
        print(" ".join(sorted(sys.modules)))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG_DIR.parent,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.strip().splitlines()[-1].split()
    for module in ("reference_style_eval", "davisinteractive.dataset",
                   "davisinteractive.session", "davisinteractive.storage",
                   "davisinteractive.utils.visualization"):
        assert f"cvpr2020_manet_tpu_torch.{module}" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def test_bundle_in_fresh_process_loads_no_models(tmp_path):
    """The export CLI writes a tiny serving bundle on the CPU; a fresh
    process that imports only `utils.export` loads it and drives one
    2-frame round from it. Neither JAX nor the port's model code
    (`models/`) is loaded there: the bundle alone carries the graphs, and
    the matching kernels come in as the `manet::*` custom ops."""
    from cvpr2020_manet_tpu_torch.utils import export_cli
    path = str(tmp_path / "b.ivosx")
    export_cli.main(["--out", path, "--tiny", "--bundle", "--device", "cpu",
                     "--matching_backend", "int8"])
    code = textwrap.dedent(f"""
        import sys
        import torch
        import torch.nn.functional as F
        from cvpr2020_manet_tpu_torch.utils import export
        b = export.load_bundle({path!r})
        h, w, _ = b["extract"].manifest["in_avals"][0][0]
        o = b.manifest["num_objects"] + 1
        g = torch.Generator().manual_seed(0)
        frames = torch.randint(0, 256, (2, h, w, 3), generator=g,
                               dtype=torch.uint8)
        feat0, emb0 = b["extract"](frames[0])
        pos = torch.zeros(h // 4, w // 4, o)
        pos[1:3, 1:3, 1] = 1.0
        bg = F.one_hot(torch.zeros(h // 4, w // 4, dtype=torch.long),
                       o).float()
        int_feats, probs0 = b["interact"](feat0, pos, torch.zeros_like(pos),
                                          bg)
        mem = b["aggregate_first"](int_feats)
        feat1, emb1 = b["extract"](frames[1])
        onehot = F.one_hot(probs0.argmax(-1).reshape(-1), o).float()
        probs1, _ = b["propagate"](feat1, emb1, emb0.reshape(-1, emb0.shape[-1]),
                                   onehot, torch.ones(h // 4, w // 4, o), emb0,
                                   probs0, mem, torch.ones(o))
        b["aggregate_update"](int_feats, mem)
        assert torch.allclose(probs1.sum(-1), torch.ones(()), atol=1e-5)
        print(" ".join(sorted(sys.modules)))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG_DIR.parent,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "cvpr2020_manet_tpu_torch.utils.export" in loaded
    assert "cvpr2020_manet_tpu_torch.ops.global_matching_cuda" in loaded
    bad = [m for m in loaded if _forbidden(m)
           or m.startswith("cvpr2020_manet_tpu_torch.models")]
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


def test_create_mesh_raises_without_cuda(monkeypatch):
    """The default mesh is every visible card: without CUDA it raises
    instead of building a mesh of CPU members."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_mesh()
    cpu = torch.device("cpu")
    assert create_mesh(data=1, context=2,
                       devices=[cpu, cpu]).context_devices == [cpu, cpu]


@pytest.mark.parametrize("engine", [Evaluator, StreamingIVOS])
def test_int8_with_cp_mesh_raises(engine):
    """int8 matching has no context-parallel fold: both engines refuse the
    pair, as in JAX, instead of matching in f32."""
    cfg = tiny_test_config()
    mesh = create_mesh(data=1, context=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="int8"):
        engine(cfg, MANet(cfg.model, device="cpu", matching_backend="int8"),
               device="cpu", cp_mesh=mesh)
    engine(cfg, MANet(cfg.model, device="cpu"), device="cpu", cp_mesh=mesh)


@pytest.mark.parametrize("engine", [Evaluator, StreamingIVOS])
def test_cp_mesh_of_another_device_type_raises(engine):
    """The cp_mesh members must be of the engine's device type: an engine
    whose members lie elsewhere would run its global matching on another
    device, through another path than its own, so both engines refuse."""
    cfg = tiny_test_config()
    mesh = create_mesh(data=1, context=2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="members"):
        engine(cfg, MANet(cfg.model, device="cpu"), device="cpu", cp_mesh=mesh)
