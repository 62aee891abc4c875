"""What every cell shares: finding a cell's files by name, building the
program under test, the clocks, the result line and the import guard.

Files are found by name under the benchmark's folder, so a later change
adds a configuration, a traffic mix or a metric as new files:

    configs/<config>.json      the configuration, as it is run
    workloads/<cell>.json      the cell: its configuration, traffic driver
                               and parameters, sample and limits
    traffic/<driver>.py        a `Traffic` class, one per kind of traffic
    metrics/<metric>.py        a `read(trace)` function, one per metric
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "cvpr2020_manet_tpu")


def cache_env(root: str = ROOT) -> None:
    """Fix every build and kernel cache to a path inside the checkout, so
    that only a cell's first run there builds (the program's own kernel
    build directory is `build/torch_kernels` under the checkout)."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


def load_json(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """The module `<kind>/<name>.py` of the benchmark, by file path."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"manet_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(man: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that cell
    `cell` reports: those that list it; an end-to-end metric without a
    list is reported by every cell. Every per-layer metric lists its
    cells."""
    if kind == "end_to_end":
        return [m for m in man[kind] if cell in m.get("workloads", [cell])]
    return [m for m in man[kind] if cell in m["workloads"]]


@dataclasses.dataclass
class Cell:
    """A cell as the drivers see it."""
    name: str
    workload: dict
    config: dict
    seed: int
    device: object


def program_config(config: dict):
    """The program's `Config` of a configuration file."""
    from cvpr2020_manet_tpu_torch.config import (
        Config, EvalConfig, ModelConfig, TrainConfig)

    def build(cls, fields):
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in fields.items()})

    return Config(model=build(ModelConfig, config["model"]),
                  eval=build(EvalConfig, config.get("eval", {})),
                  train=build(TrainConfig, config.get("train", {})))


def program_model(cfg, config: dict, weights: dict, device):
    """The program's MANet with the benchmark's weights, loaded strictly
    by name."""
    from cvpr2020_manet_tpu_torch.models.manet import MANet
    model = MANet(cfg.model, device="meta",
                  matching_backend=config.get("matching_backend", "auto"))
    model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model


def percentile(values, q: int) -> float:
    """The q-th percentile (1..99) by `statistics.quantiles`' exclusive
    method (of a single value, that value)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100)[q - 1]


def synchronize(device) -> None:
    import torch
    if getattr(device, "type", device) == "cuda":
        torch.cuda.synchronize()


def now() -> float:
    return time.perf_counter()


def forbidden_modules() -> list[str]:
    """Top-level names in `sys.modules` that a run may not load, compared
    whole (the program's package name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))
