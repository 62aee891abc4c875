"""Runs the port's DAVIS eval CLI on the CPU, with the arguments it is
given, as `python -m cvpr2020_manet_tpu_torch.engine.eval_davis` runs it
on a card: the CLI has no device flag (as in JAX), so its
`resolve_device` is patched, as `tests/test_torch_eval_davis.py` does.

    python tests/_torch_eval_davis_cpu.py --davis_root DIR --tiny ...
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import torch

    from cvpr2020_manet_tpu_torch.engine import eval_davis

    torch.set_num_threads(1)
    eval_davis.resolve_device = lambda device=None: torch.device("cpu")
    eval_davis.main(sys.argv[1:])
