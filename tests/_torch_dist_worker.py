"""One rank of a data-parallel job of the PyTorch port, for
tests/test_torch_distributed.py, tests/test_torch_syncbn.py and
chip_smoke.py's dist phase. It imports the port and nothing of JAX.

    python tests/_torch_dist_worker.py '<json spec>'

`run_ranks` (imported by the tests) starts one worker per spec.

spec keys: rank, world, port, device ("cpu" or "cuda"), backend (null:
the default of `parallel/distributed.initialize`), mode, out (a directory
for the rank's files), and per mode:

- "train": tiny (bool), batch (global), steps1, steps2, snapshot (a
  directory or null). Each step's global batch is `synthetic_batch` from
  `default_rng(1000 + step)` (stage 2: 2000 + step) and the rank trains
  on its slice; one JSON line a step on stdout (stage, step, loss,
  params' sha256, kernel launches, step and all-reduce seconds, peak
  device memory). Rank 0 writes the parameters after each stage
  (`stage<s>.pt`). With a snapshot directory, rank 0 saves the stage-1
  state behind a barrier and every rank restores it into a fresh trainer
  and prints its hash.
- "syncbn": rank r takes samples [8r, 8r + 8) of a 16 x 8 x 4 x 4 batch
  (`default_rng(0)`, NCHW) through 'syncbn' and through plain 'bn', and
  the gradient of sum(y * w) for a fixed w; writes `syncbn<r>.npz`.
- "cli": argv (the stage-1 or stage-2 CLI's arguments, with `cli`
  "stage1" or "stage2"); the device resolves to the CPU.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cvpr2020_manet_tpu_torch.parallel import distributed  # noqa: E402
from cvpr2020_manet_tpu_torch.parallel.distributed import (  # noqa: E402
    free_port)


def run_ranks(specs, timeout=600):
    """Start one worker per spec on one fresh free port (retried once on a
    port race) and wait for them all; -> their stdouts. Raises with the
    output of a rank that failed."""
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def launch(port):
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             json.dumps(dict(s, port=port))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO) for s in specs]
        return procs, [p.communicate(timeout=timeout)[0] for p in procs]

    procs, outs = launch(free_port())
    if any(p.returncode for p in procs) and any(
            "address already in use" in o.lower() for o in outs):
        procs, outs = launch(free_port())
    for p, out in zip(procs, outs):
        if p.returncode:
            raise RuntimeError(f"rank exited {p.returncode}:\n{out}")
    return outs


def state_hash(model) -> str:
    digest = hashlib.sha256()
    for k, v in model.state_dict().items():
        digest.update(k.encode())
        digest.update(v.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed_allreduce(state, record):
    """Wrap the state's gradient all-reduce to time it (synchronized)."""
    real = state.allreduce_gradients
    dev = next(state.model.parameters()).device

    def timed():
        _sync(dev)
        t = time.perf_counter()
        real()
        _sync(dev)
        record.append(time.perf_counter() - t)

    state.allreduce_gradients = timed


def _steps(trainer, cfg, stage, steps, seed0, rank):
    from cvpr2020_manet_tpu_torch.engine.train_stage1 import synthetic_batch
    from cvpr2020_manet_tpu_torch.kernels import build
    dev = trainer.device
    bl = distributed.local_batch_size(cfg.train.batch_size)
    reduce_s = []
    _timed_allreduce(trainer.state, reduce_s)
    for i in range(steps):
        full = synthetic_batch(cfg, np.random.default_rng(seed0 + i))
        local = {k: v[rank * bl:(rank + 1) * bl] for k, v in full.items()}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        _sync(dev)
        t = time.perf_counter()
        metrics = trainer.train_step(local)
        _sync(dev)
        step_s = time.perf_counter() - t
        print(json.dumps({
            "stage": stage, "step": i, "loss": metrics["loss"],
            "hash": state_hash(trainer.model),
            "launches": {k: v for k, v in build.LAUNCHES.items() if v},
            "step_s": step_s, "allreduce_s": reduce_s[-1],
            "batch_local": bl,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else None)}), flush=True)


def train(spec, rank):
    import dataclasses

    from cvpr2020_manet_tpu_torch.config import Config, tiny_test_config
    from cvpr2020_manet_tpu_torch.engine.train_stage1 import Trainer
    from cvpr2020_manet_tpu_torch.engine.train_stage2 import Stage2Trainer
    from cvpr2020_manet_tpu_torch.utils.checkpoint import CheckpointManager
    cfg = tiny_test_config() if spec["tiny"] else Config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=spec["batch"]))
    dev = spec["device"]
    trainer = Trainer(cfg, device=dev)
    print(json.dumps({"stage": 1, "step": -1,
                      "hash": state_hash(trainer.model)}), flush=True)
    _steps(trainer, cfg, 1, spec["steps1"], 1000, rank)
    if rank == 0:
        torch.save({k: v.cpu() for k, v in trainer.model.state_dict().items()},
                   os.path.join(spec["out"], "stage1.pt"))
    if spec.get("snapshot"):
        mgr = CheckpointManager(spec["snapshot"])
        if rank == 0:
            mgr.save(trainer.state)
        distributed.barrier()
        fresh = Trainer(cfg, device=dev)
        mgr.restore(fresh.state)
        print(json.dumps({"restored_step": fresh.state.step,
                          "restore_hash": state_hash(fresh.model)}),
              flush=True)
        del fresh
    del trainer
    if spec["steps2"]:
        trainer2 = Stage2Trainer(cfg, device=dev)
        _steps(trainer2, cfg, 2, spec["steps2"], 2000, rank)
        if rank == 0:
            torch.save({k: v.cpu()
                        for k, v in trainer2.model.state_dict().items()},
                       os.path.join(spec["out"], "stage2.pt"))


def syncbn(spec, rank):
    from cvpr2020_manet_tpu_torch.models.layers import make_norm
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 8, 4, 4)).astype(np.float32) * 3.0
    w = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    half = slice(8 * rank, 8 * rank + 8)
    out = {}
    for norm in ("syncbn", "bn"):
        m = make_norm(norm, torch.float32)(8)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
        xr = torch.from_numpy(x[half]).requires_grad_(True)
        y = m(xr)
        (y * torch.from_numpy(w[half])).sum().backward()
        out[f"{norm}_y"] = y.detach().numpy()
        out[f"{norm}_gx"] = xr.grad.numpy()
        out[f"{norm}_mean"] = m.mean.numpy()
        out[f"{norm}_var"] = m.var.numpy()
    np.savez(os.path.join(spec["out"], f"syncbn{rank}.npz"), **out)
    print(json.dumps({"syncbn": rank}), flush=True)


def cli(spec):
    from cvpr2020_manet_tpu_torch.engine import train_stage1, train_stage2
    cpu = lambda device=None: torch.device("cpu")  # noqa: E731
    for module in (distributed, train_stage1, train_stage2):
        module.resolve_device = cpu
    {"stage1": train_stage1, "stage2": train_stage2}[spec["cli"]].main(
        spec["argv"])


def main():
    spec = json.loads(sys.argv[1])
    if spec.get("device") == "cuda":
        # f32 runs in f32, as chip_smoke.py and the cuda tests set it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    if spec["mode"] == "cli":
        return cli(spec)
    rank, world = distributed.initialize(
        f"127.0.0.1:{spec['port']}", spec["world"], spec["rank"],
        backend=spec.get("backend"), device=spec["device"])
    assert (rank, world) == (spec["rank"], spec["world"]), (rank, world)
    try:
        {"train": train, "syncbn": syncbn}[spec["mode"]](spec, rank)
    finally:
        distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
