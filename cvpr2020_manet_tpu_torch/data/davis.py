"""DAVIS constants, from the JAX package's `data/davis.py`.

Only the ImageNet normalization the ingest paths need so far; the DAVIS
adapters (which decode JPEGs and PNGs) are not ported yet.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
