"""A training-loader dataset that also reports the modules its worker
process has loaded (tests/test_torch_isolation.py). torch and the port
only, so that a spawned worker imports nothing else to unpickle it."""

import sys

from cvpr2020_manet_tpu_torch.data.grain_pipeline import ClipBatches


class ModulesProbe(ClipBatches):
    def __getitem__(self, j):
        batch = super().__getitem__(j)
        batch["modules"] = " ".join(sorted(sys.modules))
        return batch
