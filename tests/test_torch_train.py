"""Training in the PyTorch port vs the JAX package's trainers, on the CPU.

Weights come from the Flax init through the port's bridge (`weights.py`);
batches are the same numpy arrays (`synthetic_batch`, equal in both
packages from the same seed). The JAX trainers match through the plain
`jnp` oracle (`matching_backend="jnp"`): its hard-min gradient splits
exact ties, the port's argmin routing does not, and the synthetic images
are textured at random, so there are none. Tolerances: losses to rtol 1e-4
and parameters to atol 1e-5 after the steps (f32; convolutions,
GroupNorm and the gradient sums are taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvpr2020_manet_tpu.config import tiny_test_config as jax_tiny
from cvpr2020_manet_tpu.engine import losses as jlosses
from cvpr2020_manet_tpu.engine import train_stage1 as js1
from cvpr2020_manet_tpu.engine import train_stage2 as js2
from cvpr2020_manet_tpu.engine.train_state import TrainState as JaxState
from cvpr2020_manet_tpu.engine.train_state import _param_labels
from cvpr2020_manet_tpu.engine.train_state import make_optimizer as jax_opt
from cvpr2020_manet_tpu.models import MANet as JaxMANet
from cvpr2020_manet_tpu_torch.config import tiny_test_config
from cvpr2020_manet_tpu_torch.engine import losses as tlosses
from cvpr2020_manet_tpu_torch.engine import train_stage1 as ts1
from cvpr2020_manet_tpu_torch.engine import train_stage2 as ts2
from cvpr2020_manet_tpu_torch.engine.train_state import TrainState
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.utils.checkpoint import (
    CheckpointManager, export_release, load_release)
from cvpr2020_manet_tpu_torch.weights import (
    flax_to_state_dict, load_flax_params)

LOSS_TOL = dict(rtol=1e-4, atol=0)
PARAM_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These shapes are tiny: one intra-op thread is faster than many, and
    it keeps the parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**train):
    """(JAX config, port config): the tiny config with the same overrides;
    `local_downsample` goes to the model, everything else to training."""
    model = {k: train.pop(k) for k in ("local_downsample",) if k in train}
    out = []
    for cfg in (jax_tiny(), tiny_test_config()):
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **model),
            train=dataclasses.replace(cfg.train, **train)))
    return out


@pytest.fixture(scope="module")
def flax_params():
    """Flax-initialised tiny-config parameters (numpy leaves)."""
    cfg = jax_tiny()
    model = JaxMANet(cfg.model, matching_backend="jnp")
    o = cfg.model.max_objects + 1
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 8, 8, o)), jnp.zeros((1, 8, 8, o)))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _jax_state(params, cfg):
    return JaxState.create(jax.tree_util.tree_map(jnp.asarray, params),
                           cfg.train)


def _assert_params_equal(jax_params, model):
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_params),
                              model)
    got = model.state_dict()
    for key, w in want.items():
        np.testing.assert_allclose(got[key].detach().numpy(), w.numpy(),
                                   err_msg=key, **PARAM_TOL)


def test_synthetic_batch_equals_jax():
    jcfg, tcfg = _configs()
    want = js1.synthetic_batch(jcfg, np.random.default_rng(3),
                               random_entry=True)
    got = ts1.synthetic_batch(tcfg, np.random.default_rng(3),
                              random_entry=True)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("ratio", [1.0, 0.3])
@pytest.mark.parametrize("with_valid", [False, True], ids=["all", "valid"])
def test_bootstrapped_cross_entropy_vs_jax(ratio, with_valid):
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(2, 9, 11, 4)).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 9, 11)).astype(np.int32)
    valid = ((rng.random((2, 9, 11)) > 0.4).astype(np.float32)
             if with_valid else None)
    want = jlosses.bootstrapped_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), ratio,
        None if valid is None else jnp.asarray(valid))
    got = tlosses.bootstrapped_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), ratio,
        None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        tlosses.pixel_cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels)).numpy(),
        np.asarray(jlosses.pixel_cross_entropy(jnp.asarray(logits),
                                               jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)


def test_bootstrap_ratio_schedule_vs_jax():
    """Equal in f32 at the endpoints and between: the kept count depends
    on it."""
    for warmup in (0, 3, 20_000):
        for step in (0, 1, 2, 3, 7, 19_999, 20_000, 50_000):
            want = jlosses.bootstrap_ratio_schedule(jnp.int32(step), warmup,
                                                    0.25)
            got = tlosses.bootstrap_ratio_schedule(step, warmup, 0.25)
            assert got.dtype == np.float32
            assert got == np.float32(want), (warmup, step)
    assert tlosses.bootstrap_ratio_schedule(0, 10, 0.25) == 1.0
    assert tlosses.bootstrap_ratio_schedule(10, 10, 0.25) == np.float32(0.25)


# --------------------------------------------------------------- optimizer


@pytest.mark.parametrize("updates", [1, 3])
def test_optimizer_vs_optax(flax_params, updates):
    """SGD with momentum, weight decay and poly LR, backbone at
    `backbone_lr_scale`: the same parameters as optax after the updates,
    from the same gradients."""
    _, tcfg = _configs()
    jcfg = jax_tiny()
    model = load_flax_params(MANet(tcfg.model, device="cpu"), flax_params)
    state = TrainState.create(model, tcfg.train)

    labels = _param_labels(flax_params)
    n_backbone = sum(v == "backbone"
                     for v in jax.tree_util.tree_leaves(labels))
    groups = {g["name"]: g for g in state.optimizer.param_groups}
    assert len(groups["backbone"]["params"]) == n_backbone > 0
    assert len(groups["heads"]["params"]) == \
        len(jax.tree_util.tree_leaves(labels)) - n_backbone > 0

    tx = jax_opt(jcfg.train)
    params = jax.tree_util.tree_map(jnp.asarray, flax_params)
    opt_state = tx.init(params)
    rng = np.random.default_rng(12)
    for i in range(updates):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32),
            flax_params)
        upd, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, upd)
        for key, g in flax_to_state_dict(grads, model).items():
            model.get_parameter(key).grad = g
        # the poly LR of this update, and the backbone's share of it
        factor = (1.0 - i / tcfg.train.total_steps) ** tcfg.train.poly_power
        assert groups["heads"]["lr"] == pytest.approx(
            tcfg.train.base_lr * factor, rel=1e-12)
        assert groups["backbone"]["lr"] / groups["heads"]["lr"] == \
            pytest.approx(tcfg.train.backbone_lr_scale, rel=1e-12)
        state.apply_gradients()
    assert state.step == updates
    _assert_params_equal(params, model)


# ------------------------------------------------------------------ stage 1


@pytest.mark.parametrize("local_downsample,crop", [(1, 32), (2, 64)],
                         ids=["ld1", "ld2"])
def test_stage1_steps_vs_jax(flax_params, local_downsample, crop):
    """Two steps of the whole stage-1 step (bootstrap ratio 1.0, then
    0.625) against JAX `make_train_step` + `TrainState`: losses each step,
    parameters after. At ld2 the local matching runs at half resolution,
    through the /2 and x2 resizes. The port's remat on and off agree."""
    jcfg, tcfg = _configs(local_downsample=local_downsample,
                          crop_size=(crop, crop), bootstrap_warmup_steps=2)
    batch = js1.synthetic_batch(jcfg, np.random.default_rng(13))
    jmodel = JaxMANet(jcfg.model, matching_backend="jnp",
                      trainable_matching=True)
    jstep = jax.jit(js1.make_train_step(jmodel, jcfg))
    jstate = _jax_state(flax_params, jcfg)

    trainers = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, train=dataclasses.replace(
            tcfg.train, remat=remat))
        trainers[remat] = ts1.Trainer(cfg, device="cpu")
        load_flax_params(trainers[remat].model, flax_params)
    for _ in range(2):
        jstate, want = jstep(jstate, batch)
        got = {remat: t.train_step(batch) for remat, t in trainers.items()}
        for key in ("loss", "loss_prop", "loss_int"):
            np.testing.assert_allclose(got[True][key], float(want[key]),
                                       err_msg=key, **LOSS_TOL)
            np.testing.assert_allclose(got[False][key], got[True][key],
                                       rtol=1e-6)
    _assert_params_equal(jstate.params, trainers[True].model)
    for key, p in trainers[True].model.state_dict().items():
        torch.testing.assert_close(trainers[False].model.state_dict()[key], p,
                                   rtol=0, atol=1e-6)


def test_stage1_bf16_step_vs_jax(flax_params):
    """The first stage-1 step with the model in bf16 (the flagship's
    dtype) against JAX's: the same mixed precision (bf16 convolutions and
    matching, f32 norms, softmax and losses) gives the same losses to
    bf16 rounding (measured 3.9e-4 relative at most). Later steps drift
    by that rounding, so only the first is held."""
    jcfg, tcfg = _configs(crop_size=(64, 64))
    jcfg, tcfg = (dataclasses.replace(c, model=dataclasses.replace(
        c.model, dtype="bfloat16")) for c in (jcfg, tcfg))
    batch = js1.synthetic_batch(jcfg, np.random.default_rng(5),
                                random_entry=True)
    jmodel = JaxMANet(jcfg.model, matching_backend="jnp",
                      trainable_matching=True)
    _, want = jax.jit(js1.make_train_step(jmodel, jcfg))(
        _jax_state(flax_params, jcfg), batch)
    trainer = ts1.Trainer(tcfg, device="cpu")
    load_flax_params(trainer.model, flax_params)
    got = trainer.train_step(batch)
    for key in ("loss", "loss_prop", "loss_int"):
        np.testing.assert_allclose(got[key], float(want[key]), rtol=1e-3,
                                   err_msg=key)


# ------------------------------------------------------------------ stage 2


def test_soft_iou_per_frame_vs_jax():
    rng = np.random.default_rng(14)
    probs = rng.random((3, 6, 7, 4)).astype(np.float32)
    gt = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=(3, 6, 7))]
    obj_valid = np.array([1, 1, 1, 0], np.float32)
    want = js2._soft_iou_per_frame(*map(jnp.asarray, (probs, gt, obj_valid)))
    got = ts2._soft_iou_per_frame(*map(torch.from_numpy,
                                       (probs, gt, obj_valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _scribbles(gt: np.ndarray, pred: np.ndarray, obj_valid, seed: int):
    o = len(obj_valid)
    gt_oh = torch.nn.functional.one_hot(torch.from_numpy(gt), o).float()
    pos, neg = ts2._synthesize_scribbles(
        torch.Generator().manual_seed(seed), gt_oh, torch.from_numpy(pred),
        torch.tensor(obj_valid, dtype=torch.float32))
    return pos.numpy(), neg.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthesized_scribbles_inside_error_region(seed):
    h, w = 16, 16
    gt = np.zeros((h, w), np.int64)
    gt[4:12, 4:12] = 1
    pred = np.zeros((h, w), np.int64)               # all background
    pos, neg = _scribbles(gt, pred, [1.0, 1.0, 0.0], seed)
    ys, xs = np.nonzero(pos[..., 1])
    assert len(ys) > 0
    assert (gt[ys, xs] == 1).all()                  # inside the error
    assert pos[..., 2].sum() == 0                   # no invalid object
    assert not ((pos > 0) & (neg > 0)).any()


def _connected(mask: np.ndarray) -> bool:
    ys, xs = np.nonzero(mask)
    pix = set(zip(ys.tolist(), xs.tolist()))
    seen = {next(iter(pix))}
    frontier = list(seen)
    while frontier:
        y, x = frontier.pop()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                p = (y + dy, x + dx)
                if p in pix and p not in seen:
                    seen.add(p)
                    frontier.append(p)
    return len(seen) == len(pix)


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_synthesized_scribbles_are_line_like_and_cover_blobs(seed):
    """Strokes are elongated, connected lines, and each of two error blobs
    gets one."""
    h, w = 32, 32
    gt = np.zeros((h, w), np.int64)
    gt[4:14, 4:14] = 1
    gt[20:30, 20:30] = 1
    pred = np.zeros((h, w), np.int64)
    pos, _ = _scribbles(gt, pred, [1.0, 1.0], seed)
    stroke = pos[..., 1] > 0
    assert stroke.sum() >= 8
    for sl in (np.s_[:16, :16], np.s_[16:, 16:]):
        by, bx = np.nonzero(stroke[sl])
        assert len(by) >= 4, "each error blob gets a stroke"
        pts = np.stack([by, bx], 1).astype(np.float64)
        evals = np.sort(np.linalg.eigvalsh(np.cov((pts - pts.mean(0)).T)))
        assert evals[1] > 6 * max(evals[0], 1e-9), "stroke is elongated"
        assert _connected(stroke[sl]), "stroke is connected"


def test_synthesized_background_correction_strokes():
    """False positives give background strokes (channel 0), which become
    the object's negatives."""
    h, w = 16, 16
    gt = np.zeros((h, w), np.int64)
    pred = np.zeros((h, w), np.int64)
    pred[4:12, 4:12] = 1
    pos, neg = _scribbles(gt, pred, [1.0, 1.0], 0)
    ys, xs = np.nonzero(pos[..., 0])
    assert len(ys) > 0
    assert (pred[ys, xs] == 1).all()
    assert (neg[ys, xs, 1] == 1).all()


def _stripes(h, w):
    return ((np.arange(h)[:, None] + 2 * np.arange(w)[None]) % 3 == 0
            ).astype(np.float32)[..., None]


def _fake_scribbles_jax(key, gt_oh, pred_labels, obj_valid):
    """A deterministic stand-in for the random strokes: the error region on
    fixed stripes."""
    h, w, o = gt_oh.shape
    err = gt_oh * (1.0 - jax.nn.one_hot(pred_labels, o))
    pos = err * _stripes(h, w) * obj_valid
    return pos, (pos.max(-1, keepdims=True) - pos) * obj_valid


def _fake_scribbles_torch(gen, gt_oh, pred_labels, obj_valid):
    h, w, o = gt_oh.shape
    err = gt_oh * (1.0 - torch.nn.functional.one_hot(pred_labels, o).float())
    pos = err * torch.from_numpy(_stripes(h, w)) * obj_valid
    return pos, (pos.amax(-1, keepdim=True) - pos) * obj_valid


@pytest.mark.parametrize("gmap_memory", [False, True],
                         ids=["no_gmap_memory", "gmap_memory"])
def test_stage2_step_vs_jax(flax_params, monkeypatch, gmap_memory):
    """One stage-2 step (3 simulated rounds over 3-frame clips) against
    JAX `make_train_step`, with the random strokes replaced by the same
    deterministic function in both packages: the loss, and the parameters
    after the update."""
    monkeypatch.setattr(js2, "_synthesize_scribbles", _fake_scribbles_jax)
    monkeypatch.setattr(ts2, "_synthesize_scribbles", _fake_scribbles_torch)
    jcfg, tcfg = _configs(stage2_gmap_memory=gmap_memory)
    batch = js1.synthetic_batch(jcfg, np.random.default_rng(15))
    jmodel = JaxMANet(jcfg.model, matching_backend="jnp",
                      trainable_matching=True)
    jstate, want = jax.jit(js2.make_train_step(jmodel, jcfg))(
        _jax_state(flax_params, jcfg), batch, jax.random.PRNGKey(0))
    trainer = ts2.Stage2Trainer(tcfg, device="cpu")
    load_flax_params(trainer.model, flax_params)
    got = trainer.train_step(batch)
    np.testing.assert_allclose(got["loss"], float(want["loss"]), **LOSS_TOL)
    _assert_params_equal(jstate.params, trainer.model)


# -------------------------------------------------------------- checkpoints


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    """Save after two steps, restore into a trainer with other weights, one
    more step: the same parameters as three steps without a break."""
    _, cfg = _configs()
    rng = np.random.default_rng(16)
    batches = [ts1.synthetic_batch(cfg, rng) for _ in range(3)]
    straight = ts1.Trainer(cfg, device="cpu")
    for b in batches:
        straight.train_step(b)

    first = ts1.Trainer(cfg, device="cpu")
    for b in batches[:2]:
        first.train_step(b)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(first.state)
    assert mgr.latest_step() == 2
    resumed = ts1.Trainer(cfg, device="cpu", seed=7)
    mgr.restore(resumed.state)
    assert resumed.state.step == 2
    resumed.train_step(batches[2])
    want = straight.model.state_dict()
    for key, p in resumed.model.state_dict().items():
        torch.testing.assert_close(p, want[key], rtol=0, atol=0)


def test_checkpoint_retention_keeps_three(tmp_path):
    _, cfg = _configs()
    state = TrainState.create(MANet(cfg.model, device="cpu"), cfg.train)
    mgr = CheckpointManager(str(tmp_path))
    for step in range(1, 6):
        state.step = step
        mgr.save(state)
    assert mgr.all_steps() == [3, 4, 5]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_release_round_trip(tmp_path):
    _, cfg = _configs()
    model = MANet(cfg.model, device="cpu", seed=4)
    export_release(model.state_dict(), str(tmp_path))
    with pytest.raises(FileExistsError):
        export_release(model.state_dict(), str(tmp_path))
    template = MANet(cfg.model, device="cpu", seed=5).state_dict()
    loaded = load_release(template, str(tmp_path))
    for key, p in model.state_dict().items():
        assert torch.equal(loaded[key], p)
    with pytest.raises(KeyError):
        load_release({"stray": torch.zeros(1)}, str(tmp_path))


# --------------------------------------------------------------------- CLI


def test_cli_trains_on_cpu(monkeypatch, tmp_path, capsys):
    """Both trainer CLIs at the tiny config, the device resolved to the
    CPU (the CLIs, like the JAX ones, have no device flag): metrics log,
    checkpoints, resume and the release export."""
    cpu = lambda device=None: torch.device("cpu")
    monkeypatch.setattr(ts1, "resolve_device", cpu)
    monkeypatch.setattr(ts2, "resolve_device", cpu)
    snap, logs, rel = (str(tmp_path / d) for d in ("snap", "logs", "rel"))
    ts1.main(["--tiny", "--synthetic", "--steps", "2", "--snapshot_dir",
              snap, "--log_dir", logs, "--release", rel])
    assert CheckpointManager(snap).latest_step() == 2
    lines = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and '"loss_prop"' in lines[0]
    assert (tmp_path / "rel" / "params.pt").exists()
    ts1.main(["--tiny", "--synthetic", "--steps", "1", "--snapshot_dir",
              snap])
    assert CheckpointManager(snap).latest_step() == 3
    assert "resumed from step 2" in capsys.readouterr().out
    ts2.main(["--tiny", "--synthetic", "--steps", "1", "--sim_rounds", "2",
              "--gmap_memory"])
    assert "step 0: loss=" in capsys.readouterr().out
