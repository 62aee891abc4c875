"""The DAVIS evaluation CLI on the card against the same CLI on the CPU.

A CUDA kernel has no CPU mode, so this test skips without a GPU. On a
machine with one (and no JAX) run it without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_eval_davis_cuda.py

The tree comes from tests/_torch_davis_tree.py (a numpy JPEG encoder,
the port's PNG writer; the test needs no PIL). The tiny model (f32,
seeded weights) runs the CLI on the CPU, then on the card (kernel 1's f32
variant, kernel 2, cuDNN, TF32 off), in lockstep. A round takes three
kinds of argmax: the matching reference's labels (the interaction
output's, on the annotated frame), the previous frame's labels that each
sweep step's local matching takes, and the masks. Between two devices an
argmax can flip where the top two probabilities lie close, and a flip
moves what follows (a reference pixel the nearest distances of many
queries, a local label the next frames, a mask pixel the next round's
scribbles). So at each of these sites the card's labels may differ from
the CPU's only at argmax ties, pixels where the CPU's top-2
probabilities lie within TIE, and there the card takes the CPU's labels.
Sweep steps over the padding frames of a frame bucket are not held:
their outputs are dropped (and GroupNorm over a constant frame is where
the devices part most). Then the two reports' metric columns must be
equal. The lockstep reads and replaces the local labels inside each
sweep step, which a replayed CUDA graph runs no Python for: on the card
the steps run as they are here (`round_graph.captures` patched). A second
test runs the same CLI on the card twice, its sweep steps run as they are
and replayed from CUDA graphs as the CLI runs them, and the two reports
must be equal (tests/test_torch_round_graph_cuda.py holds single rounds
of the two bit for bit).

The seeded weights give nearly flat probabilities: the top two lie
within 2e-3 at about two thirds of the reference pixels, within 1e-5 at
2.2%. On an NVIDIA H100 the CPU's top-2 gap at a pixel whose label the
card flipped was at most 3.9e-7 (at the masks; 3e-8 at the reference and
the local labels), and chip_smoke.py measures a tiny round's
probabilities within 4.5e-7 of the CPU's. TIE is 2e-6, four times that;
the test holds each site's tie share, over the pixels it checks, under
MAX_TIE_SHARE, and prints the shares and the flips.
"""

import numpy as np
import pytest
import torch

from _torch_davis_tree import write_davis_tree
from cvpr2020_manet_tpu_torch.engine import eval_davis, round_graph
from cvpr2020_manet_tpu_torch.engine.evaluator import Evaluator
from cvpr2020_manet_tpu_torch.interactive.session import (
    REPORT_COLUMNS, read_report_csv)
from cvpr2020_manet_tpu_torch.models import MANet
from cvpr2020_manet_tpu_torch.models.layers import resize_bilinear

pytestmark = pytest.mark.cuda

TIE = 2e-6
MAX_TIE_SHARE = 0.01


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _gaps(probs: torch.Tensor) -> np.ndarray:
    """Top-1 minus top-2 probability per pixel."""
    top2 = probs.float().cpu().topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


def _mask_gaps(ev, state, image_hw):
    h, w = image_hw
    pad = ev.cfg.eval.pad_to
    probs = state.prev_masks[:state.num_frames].float().cpu()
    up = resize_bilinear(probs, (h + (-h) % pad, w + (-w) % pad))
    return _gaps(up)[:, :h, :w]


class _Lockstep:
    """Records the CPU run's labels and top-2 gaps at each argmax site, in
    call order; then holds the card run's against them and hands back the
    CPU's."""

    def __init__(self):
        self.recording = True
        self.sites = {"reference": [], "local": [], "masks": []}
        self.pos = dict.fromkeys(self.sites, 0)
        # over the card run's checked calls: pixels, ties, flips at ties,
        # the largest CPU gap at a flipped pixel
        self.checked = {site: [0, 0, 0, 0.0] for site in self.sites}
        self.valid_steps = []         # the current span's sweep steps
        self.step_valid = True

    def labels(self, site, got, got_labels, gaps, check=True):
        """got: what the run computed; got_labels its argmax labels."""
        if self.recording:
            self.sites[site].append((got, got_labels, gaps))
            return got
        want, want_labels, gaps = self.sites[site][self.pos[site]]
        self.pos[site] += 1
        if not check:
            return got
        tie = gaps <= TIE
        differ = got_labels != want_labels
        assert not (differ & ~tie).any(), (
            f"{site} {self.pos[site] - 1}: {int((differ & ~tie).sum())} "
            "labels differ outside argmax ties")
        count = self.checked[site]
        count[0] += tie.size
        count[1] += int(tie.sum())
        count[2] += int(differ.sum())
        count[3] = max(count[3], float(gaps[differ].max(initial=0.0)))
        return want

    def patch(self, monkeypatch):
        real_interaction = Evaluator._interaction
        real_sweep = Evaluator._sweep_impl
        real_round = Evaluator.run_round
        real_propagate = MANet.propagate
        real_local = MANet._local_matching

        def interaction(ev, *args):
            *out, ref_onehot = real_interaction(ev, *args)
            got = ref_onehot.cpu()
            want = self.labels("reference", got, got.argmax(-1).numpy(),
                               _gaps(out[0]).reshape(-1))
            return (*out, want.to(ref_onehot.device))

        def sweep(ev, state, head, annot, probs, gmap, frame_valid):
            t = state.emb.shape[0]
            frame = np.concatenate([np.arange(annot + 1, t),
                                    np.arange(annot - 1, -1, -1)])
            self.valid_steps = list(frame_valid.cpu().numpy()[frame])
            return real_sweep(ev, state, head, annot, probs, gmap,
                              frame_valid)

        def propagate(model, *args, **kw):
            self.step_valid = bool(self.valid_steps.pop(0))
            self.prev_gaps = _gaps(args[7])          # prev_mask
            return real_propagate(model, *args, **kw)

        def local(model, query, prev, prev_onehot):
            got = prev_onehot.cpu()
            want = self.labels("local", got, got.argmax(-1).numpy(),
                               self.prev_gaps, check=self.step_valid)
            return real_local(model, query, prev,
                              want.to(prev_onehot.device))

        def run_round(ev, state, scribbles, image_hw, num_objects):
            masks = real_round(ev, state, scribbles, image_hw, num_objects)
            return self.labels("masks", masks, masks,
                               _mask_gaps(ev, state, image_hw))

        monkeypatch.setattr(round_graph, "captures", lambda device: False)
        monkeypatch.setattr(Evaluator, "_interaction", interaction)
        monkeypatch.setattr(Evaluator, "_sweep_impl", sweep)
        monkeypatch.setattr(Evaluator, "run_round", run_round)
        monkeypatch.setattr(MANet, "propagate", propagate)
        monkeypatch.setattr(MANet, "_local_matching", local)


def _cli_args(tmp_path):
    """A two-sequence DAVIS tree (16 frames and 9, 2 objects each) and the
    tiny CLI's arguments over it, 3 rounds of 2 scribble sets."""
    root = tmp_path / "DAVIS"
    write_davis_tree(str(root), (128, 192), (("a", 16, 2, 0), ("b", 9, 2, 1)),
                     2)
    return ["--davis_root", str(root), "--tiny", "--rounds", "3",
            "--scribble_sets", "2", "--max_frames", "16",
            "--image_size", "128", "192"]


def _rows(path):
    """A report's metric columns, row by row."""
    return [[r[c] for c in REPORT_COLUMNS[:-1]]
            for r in read_report_csv(str(path))]


def test_tiny_cli_on_card_equals_cpu(cuda, tmp_path, monkeypatch):
    args = _cli_args(tmp_path)
    lock = _Lockstep()
    lock.patch(monkeypatch)
    devices = []
    monkeypatch.setattr(eval_davis, "resolve_device",
                        lambda device=None: devices[-1])
    for device in ("cpu", "cuda"):
        devices.append(torch.device(device))
        lock.recording = device == "cpu"
        eval_davis.main(args + ["--report", str(tmp_path / f"{device}.csv")])
    for site, calls in lock.sites.items():
        assert lock.pos[site] == len(calls) > 0, site
    assert len(lock.sites["masks"]) == 2 * 2 * 3
    for site, (pixels, ties, flips, gap) in lock.checked.items():
        print(f"{site}: {ties} argmax ties of {pixels} checked pixels "
              f"({ties / pixels:.4%}), {flips} labels flipped at ties, "
              f"the largest CPU gap at a flip {gap:.3g}")
        assert ties / pixels < MAX_TIE_SHARE, site
    assert _rows(tmp_path / "cuda.csv") == _rows(tmp_path / "cpu.csv")


def test_tiny_cli_graphed_on_card_equals_eager(cuda, tmp_path, monkeypatch):
    """The tiny (f32) CLI on the card, its sweep steps run as they are and
    then replayed from CUDA graphs: the same report."""
    args = _cli_args(tmp_path)
    monkeypatch.setattr(eval_davis, "resolve_device", lambda device=None: cuda)
    graphed_sweeps = []
    real_run = round_graph.SweepSteps.run

    def run(steps, *a, **kw):
        graphed_sweeps.append(round_graph.captures(a[1].device))
        return real_run(steps, *a, **kw)

    monkeypatch.setattr(round_graph.SweepSteps, "run", run)
    with monkeypatch.context() as m:
        m.setattr(round_graph, "captures", lambda device: False)
        eval_davis.main(args + ["--report", str(tmp_path / "eager.csv")])
    n = len(graphed_sweeps)
    eval_davis.main(args + ["--report", str(tmp_path / "graphed.csv")])
    # 2 sequences x 2 scribble sets x 3 rounds, each sweep once
    assert graphed_sweeps == [False] * n + [True] * n and n == 12
    eager = _rows(tmp_path / "eager.csv")
    graphed = _rows(tmp_path / "graphed.csv")
    assert len(eager) == 2 * 2 * 3 * (16 + 9) and graphed == eager
