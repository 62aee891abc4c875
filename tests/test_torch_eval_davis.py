"""The port's DAVIS evaluation CLI against the JAX package's, on the CPU, on
the synthetic DAVIS tree (tests/conftest.py `davis_root`).

Both CLIs get the same weights: JAX variables from PRNGKey(7), exported
with JAX's `export_release` and bridged through `weights.py` into the
port's `export_release`, passed as `--checkpoint` to each. The two run in
lockstep: every round's label map of the port must equal JAX's except at
argmax ties (pixels where JAX's top-2 probabilities lie within 1e-5; the
packages differ only in f32 summation order), and the tie pixels take
JAX's labels before the session, the robot and --save_masks see them, so
that the next round gets the same scribbles. Then the reports' metric
columns (sequence, scribble set, round, object, frame, J, F), the saved
PNGs and `rounds_run` must be equal: in the default mode, with
--mask_stride 2, and with --matching_memory stacked --context_parallel 4
(the port on 4 CPU members, JAX on 4 of its 8 virtual CPU devices). Under
--matching_int8 JAX's CLI asks for the Pallas int8 kernel, which runs on
the CPU only in interpret mode, so its model is given the interpret
backend; int8 embeddings differ by ~1e-6 between the packages, so a
channel on a rounding edge can land one quantization step apart: there
each round's labels must agree on at least 0.999 of the pixels. Under --host
each CLI runs against its own package's evaluation server, in the same
lockstep. A run interrupted after its first item and resumed, and the
port's CLI against the port's and JAX's evaluation servers, give the
uninterrupted local run's metric columns exactly. The port's remote view
departs from JAX's in what it feeds the model only at padding, and a test
shows where and by how much. The three SystemExits are covered.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvpr2020_manet_tpu.models as jax_models
from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.data.davis import DavisEvalDataset as JaxDavis
from cvpr2020_manet_tpu.engine.evaluator import Evaluator as JaxEvaluator
from cvpr2020_manet_tpu.engine.eval_davis import main as jax_main
from cvpr2020_manet_tpu.interactive import service as jax_service
from cvpr2020_manet_tpu.models.layers import resize_bilinear as jax_resize
from cvpr2020_manet_tpu.utils.checkpoint import (
    export_release as jax_export_release)
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.data.davis import DavisEvalDataset
from cvpr2020_manet_tpu_torch.engine import eval_davis
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.interactive import service
from cvpr2020_manet_tpu_torch.interactive.session import (
    REPORT_COLUMNS, read_report_csv)
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.utils.checkpoint import export_release
from cvpr2020_manet_tpu_torch.utils.colormap import load_indexed_png
from cvpr2020_manet_tpu_torch.weights import load_flax_params

METRIC_COLS = REPORT_COLUMNS[:-1]
MIN_AGREE_INT8 = 0.999
TIE = 1e-5
BASE_ARGS = ["--subset", "val", "--rounds", "3", "--scribble_sets", "2",
             "--max_frames", "4", "--image_size", "64", "96", "--tiny"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(JAX release dir, port release dir) of the same PRNGKey(7) weights."""
    cfg = jax_tiny()
    model = jax_models.MANet(cfg.model)
    h, w = cfg.eval.image_size
    o = cfg.model.max_objects + 1
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(7), jnp.zeros((1, h, w, 3)),
        jnp.zeros((1, h // 4, w // 4, o)), jnp.zeros((1, h // 4, w // 4, o)))
    jdir = str(tmp_path_factory.mktemp("jax_release") / "params")
    jax_export_release(variables["params"], jdir)
    tmodel = load_flax_params(
        MANet(tiny_test_config().model, device="cpu"),
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    tdir = str(tmp_path_factory.mktemp("port_release"))
    export_release(tmodel.state_dict(), tdir)
    return jdir, tdir


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(eval_davis, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_int8_interpret(monkeypatch):
    """JAX's CLI builds MANet(..., matching_backend="pallas_int8"), which
    needs a TPU; on the CPU the same kernel runs in interpret mode."""
    real = jax_models.MANet

    def interpret(cfg, matching_backend="auto", **kw):
        if matching_backend == "pallas_int8":
            matching_backend = "pallas_int8_interpret"
        return real(cfg, matching_backend=matching_backend, **kw)
    monkeypatch.setattr(jax_models, "MANet", interpret)


def _run(main, davis_root, out, ckpt, extra=(), capsys=None):
    report = os.path.join(out, "report.csv")
    masks = os.path.join(out, "masks")
    main(["--davis_root", davis_root, *BASE_ARGS, "--checkpoint", ckpt,
          "--report", report, "--save_masks", masks, *extra])
    line = None
    if capsys is not None:
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return report, masks, line


def _port_rows(report):
    return [[r[c] for c in METRIC_COLS] for r in read_report_csv(report)]


def _mask_files(masks):
    files = sorted(glob.glob(os.path.join(masks, "*", "*", "*.png")))
    return [os.path.relpath(f, masks) for f in files]


class _Lockstep:
    """Records each JAX round's labels and argmax-tie pixels, then holds
    the port's rounds, in the same order, against them."""

    def __init__(self, int8: bool):
        self.int8 = int8
        self.rounds, self.next = [], 0

    def jax_run_round(self, real):
        def run_round(ev, state, scribbles, image_hw, num_objects):
            masks = real(ev, state, scribbles, image_hw, num_objects)
            h, w = image_hw
            pad, ms = ev.cfg.eval.pad_to, ev.cfg.eval.mask_stride
            hw_mask = ((h + (-h) % pad) // ms, (w + (-w) % pad) // ms)
            p = np.asarray(state.prev_masks)[:state.num_frames]
            up = np.sort(np.asarray(jax_resize(jnp.asarray(p), hw_mask)),
                         axis=-1)
            up = np.repeat(np.repeat(up, ms, axis=1), ms, axis=2)
            self.rounds.append((masks, (up[..., -1] - up[..., -2]
                                        <= TIE)[:, :h, :w]))
            return masks
        return run_round

    def port_run_round(self, real):
        def run_round(ev, state, scribbles, image_hw, num_objects):
            masks = real(ev, state, scribbles, image_hw, num_objects)
            want, tie = self.rounds[self.next]
            differ = masks != want
            if self.int8:
                assert float((~differ).mean()) >= MIN_AGREE_INT8, self.next
            else:
                assert not (differ & ~tie).any(), (
                    f"round {self.next}: {int((differ & ~tie).sum())} "
                    "labels differ outside argmax ties")
            self.next += 1
            return np.where(differ, want, masks)
        return run_round


@pytest.mark.parametrize("extra", [
    [], ["--mask_stride", "2"],
    ["--matching_memory", "stacked", "--context_parallel", "4"],
    ["--matching_int8"], ["--host"]],
    ids=["default", "mask_stride2", "cp4", "int8", "host"])
def test_cli_matches_jax(davis_root, tmp_path, checkpoints, capsys, extra,
                         request, monkeypatch):
    """--host: each CLI against its own package's evaluation server."""
    jdir, tdir = checkpoints
    int8 = "--matching_int8" in extra
    if int8:
        request.getfixturevalue("jax_int8_interpret")
    step = _Lockstep(int8)
    monkeypatch.setattr(JaxEvaluator, "run_round",
                        step.jax_run_round(JaxEvaluator.run_round))
    monkeypatch.setattr(Evaluator, "run_round",
                        step.port_run_round(Evaluator.run_round))
    servers = []

    def args(serve, dataset):
        if extra != ["--host"]:
            return extra
        srv, _ = serve(dataset(davis_root, scribble_sets=2))
        servers.append(srv)
        return ["--host", f"http://127.0.0.1:{srv.server_address[1]}"]
    try:
        ref = _run(jax_main, davis_root, str(tmp_path / "jax"), jdir,
                   args(jax_service.serve, JaxDavis), capsys)
        port = _run(eval_davis.main, davis_root, str(tmp_path / "port"),
                    tdir, args(service.serve, DavisEvalDataset), capsys)
    finally:
        for srv in servers:
            srv.shutdown()
    assert step.next == len(step.rounds) == 2 * 2 * 3
    assert port[2]["rounds_run"] == ref[2]["rounds_run"] == 2 * 2 * 3
    assert set(port[2]) == set(ref[2]) == {
        "auc", "jf_at_60s", "p50_round_latency_s", "rounds_run",
        "p50_by_frame_bucket"}
    assert list(port[2]["p50_by_frame_bucket"]) == ["4"]
    files = _mask_files(port[1])
    assert files == _mask_files(ref[1]) and len(files) == 2 * 2 * 4
    assert files[0] == os.path.join("scribble1", "seq_a", "00000.png")
    for f in files:
        np.testing.assert_array_equal(
            load_indexed_png(os.path.join(port[1], f)),
            load_indexed_png(os.path.join(ref[1], f)))
    port_rows = _port_rows(port[0])
    assert len(port_rows) == 2 * 2 * 3 * 2 * 4
    # JAX's CSV (pandas' to_csv) read with the port's reader: pandas' own
    # float parser need not round-trip every repr
    assert port_rows == _port_rows(ref[0])


def test_resume_equals_uninterrupted(davis_root, tmp_path, checkpoints,
                                     monkeypatch, capsys):
    """Stop after the first item's checkpoint (an exception from the
    progress hook), resume: the stitched report's metric columns equal an
    uninterrupted run's, and stderr reports the items it found."""
    _, tdir = checkpoints
    full, _, _ = _run(eval_davis.main, davis_root, str(tmp_path / "full"),
                      tdir)
    report = str(tmp_path / "resumed" / "report.csv")
    args = ["--davis_root", davis_root, *BASE_ARGS, "--checkpoint", tdir,
            "--report", report, "--resume"]

    class Stop(Exception):
        pass

    from cvpr2020_manet_tpu_torch.interactive import session as session_mod
    real_init = session_mod.InteractiveSession.__init__

    def stopping_init(self, *a, on_item_end=None, **kw):
        def hook(seq, set_idx):
            on_item_end(seq, set_idx)
            raise Stop
        real_init(self, *a, on_item_end=hook, **kw)
    monkeypatch.setattr(session_mod.InteractiveSession, "__init__",
                        stopping_init)
    with pytest.raises(Stop):
        eval_davis.main(args)
    monkeypatch.setattr(session_mod.InteractiveSession, "__init__",
                        real_init)
    assert len({(r["sequence"], r["scribble_idx"])
                for r in read_report_csv(report)}) == 1
    capsys.readouterr()
    eval_davis.main(args)
    assert "resume: 1 completed items found" in capsys.readouterr().err
    assert _port_rows(report) == _port_rows(full)


@pytest.mark.parametrize("server", ["port", "jax"])
def test_host_equals_local(davis_root, tmp_path, checkpoints, server):
    """--host against the port's and JAX's evaluation servers: the same
    metric columns as the local run."""
    _, tdir = checkpoints
    local, _, _ = _run(eval_davis.main, davis_root, str(tmp_path / "local"),
                       tdir)
    if server == "port":
        srv, _ = service.serve(DavisEvalDataset(davis_root, scribble_sets=2))
    else:
        srv, _ = jax_service.serve(JaxDavis(davis_root, scribble_sets=2))
    try:
        remote, _, _ = _run(
            eval_davis.main, davis_root, str(tmp_path / "remote"), tdir,
            ["--host", f"http://127.0.0.1:{srv.server_address[1]}"])
    finally:
        srv.shutdown()
    assert _port_rows(remote) == _port_rows(local)


def test_remote_frames_differ_from_jax_only_at_padding(tmp_path,
                                                       monkeypatch):
    """The port's remote dataset view passes the local source's uint8
    frames on, where JAX's offers only normalized floats. What each
    package's remote path feeds the encoder, on frames that need spatial
    and frame-bucket padding: bit-equal inside the frames; in the padding,
    JAX's 0.0 against the port's normalized mean byte, at most 0.0082 per
    channel. Frames that need no padding (the davis_root fixture's) feed
    both packages the same values."""
    from _torch_davis_tree import write_davis_tree
    from cvpr2020_manet_tpu.engine.evaluator import (
        pad_image_to as jax_pad_image_to)
    from cvpr2020_manet_tpu_torch.data.davis import (
        IMAGENET_MEAN, IMAGENET_STD)
    root = str(tmp_path / "DAVIS")
    h, w, t = 56, 90, 3
    write_davis_tree(root, (h, w), (("s", t, 2, 0),), 1)
    port_view = service._RemoteDatasetView(None, DavisEvalDataset(root))
    jax_view = jax_service._RemoteDatasetView(None, JaxDavis(root))
    assert not hasattr(jax_view, "images_uint8")

    cfg = tiny_test_config()
    ev = Evaluator(cfg, MANet(cfg.model, device="cpu", seed=0), device="cpu")
    fed = []
    real = ev.model.extract_features

    def extract(x):
        fed.append(x.numpy().copy())
        return real(x)
    monkeypatch.setattr(ev.model, "extract_features", extract)
    ev.start_sequence(port_view.images_uint8("s"), 2)
    port_in = np.concatenate(fed)
    # JAX's start_sequence on floats: pad_image_to, then 0.0 frames up to
    # the frame bucket
    jax_in = jax_pad_image_to(jax_view.images("s"), cfg.eval.pad_to)
    jax_in = np.concatenate([jax_in, np.zeros(
        (port_in.shape[0] - t, *jax_in.shape[1:]), np.float32)])
    assert port_in.shape == jax_in.shape == (4, 64, 96, 3)

    inside = np.zeros(port_in.shape[:3], bool)
    inside[:t, :h, :w] = True
    np.testing.assert_array_equal(port_in[inside], jax_in[inside])
    assert (jax_in[~inside] == 0.0).all()
    mean_byte = np.round(IMAGENET_MEAN * 255) / 255
    pad = ((mean_byte - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    np.testing.assert_allclose(port_in[~inside],
                               np.broadcast_to(pad, port_in[~inside].shape),
                               rtol=1e-6)
    assert 0.008 < np.abs(pad).max() < 0.0082


def test_system_exits(davis_root, tmp_path):
    args = ["--davis_root", davis_root, *BASE_ARGS]
    with pytest.raises(SystemExit, match="single-device"):
        eval_davis.main(args + ["--matching_int8", "--context_parallel", "2"])
    with pytest.raises(SystemExit, match="needs a local session"):
        eval_davis.main(args + ["--resume", "--host", "http://127.0.0.1:9"])
    with pytest.raises(SystemExit, match="needs --report"):
        eval_davis.main(args + ["--resume"])
