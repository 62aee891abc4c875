"""Training metrics log, PyTorch port of `utils/logging.py`.

`MetricLogger` prints one line per write. With `log_dir` it appends each
write as one JSON object per line to `<log_dir>/metrics.jsonl` instead
(the JAX package writes TensorBoard events through `clu` there, which the
port does not depend on).
"""

from __future__ import annotations

import json
import os
from typing import Mapping


class MetricLogger:
    def __init__(self, log_dir: str | None = None):
        self._file = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                              buffering=1)

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._file is not None:
            self._file.write(json.dumps({"step": int(step), **metrics}) + "\n")
        else:
            line = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            print(f"step {step}: {line}", flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
