"""`davisinteractive.robot`: the scribble robot in the upstream calling
convention.

The upstream constructor's knobs map onto the port's `RobotParams`
(`interactive/robot.py`): `kernel_size` is the erosion kernel (relative
to the region), `max_kernel_radius` caps the erosion radius in pixels,
`min_nb_nodes` is the fewest polyline nodes of a scribble, and
`nb_points` the most.
"""

import dataclasses
from typing import List, Optional

import numpy as np

from cvpr2020_manet_tpu_torch.interactive.robot import (
    InteractiveScribblesRobot as _Robot, RobotParams)

__all__ = ["InteractiveScribblesRobot"]


class InteractiveScribblesRobot(_Robot):
    """Upstream signature: `interact(sequence, pred_masks, gt_masks,
    nb_objects=None, frame=None)` returns the scribble payload as a JSON
    dict (the port's robot returns a typed `Scribbles`)."""

    def __init__(self, kernel_size: float = 0.15,
                 max_kernel_radius: int = 16,
                 min_nb_nodes: int = 4,
                 nb_points: int = 1000):
        super().__init__(dataclasses.replace(
            RobotParams(), kernel_size=kernel_size,
            max_kernel_radius=float(max_kernel_radius),
            min_path_nodes=min_nb_nodes,
            max_path_points=nb_points))

    def interact(self, sequence: str, pred_masks: np.ndarray,
                 gt_masks: np.ndarray, nb_objects: Optional[int] = None,
                 frame: Optional[int] = None,
                 annotated: Optional[List[int]] = None) -> dict:
        pred_masks = np.asarray(pred_masks)
        gt_masks = np.asarray(gt_masks)
        if nb_objects is None:
            n = int(np.max(gt_masks)) if gt_masks.size else 0
            nb_objects = max(n, 1)
        if frame is None:
            scr = super().interact(sequence, pred_masks, gt_masks,
                                   nb_objects, annotated=annotated)
        else:
            scr = self.scribble_frame(
                pred_masks[frame], gt_masks[frame], nb_objects, frame,
                pred_masks.shape[0], sequence)
        return scr.to_json()
