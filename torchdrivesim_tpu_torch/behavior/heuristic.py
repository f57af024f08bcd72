"""
Heuristic scenario initialization: rejection-sampled placement on lanelet
centerlines with disc-collision checks (counterpart of
``torchdrivesim_tpu/behavior/heuristic.py``). Host numpy code.
"""
import random
from typing import Tuple

import numpy as np

from torchdrivesim_tpu_torch.behavior.common import InitializationFailedError
from torchdrivesim_tpu_torch.lanelet2 import pick_random_point_and_orientation

#: fixed car geometry used by the reference initializer
CAR_LENGTH = 4.97
CAR_WIDTH = 2.04
CAR_LR = 1.96


def _discs_np(box: np.ndarray, num_discs: int = 5):
    """Disc decomposition of (..., 5) boxes: centers (..., D, 2), radii."""
    half = (num_discs - 1) // 2
    xy, length, width, yaw = box[..., :2], box[..., 2], box[..., 3], box[..., 4]
    r = np.minimum(length, width) / 2
    span = np.maximum(length, width) / 2 - r
    offs = np.asarray([i / half for i in range(-half, half + 1)])
    yaw_eff = yaw + (np.pi / 2) * (width > length)
    cx = offs[None] * span[..., None] * np.cos(yaw_eff)[..., None] + xy[..., 0:1]
    cy = offs[None] * span[..., None] * np.sin(yaw_eff)[..., None] + xy[..., 1:2]
    return np.stack([cx, cy], axis=-1), r


def _discs_collide(box_a: np.ndarray, boxes_b: np.ndarray, num_discs: int = 5) -> bool:
    """Disc collision check between one box and a set of boxes."""
    ca, ra = _discs_np(box_a[None], num_discs)
    cb, rb = _discs_np(boxes_b, num_discs)
    diff = ca[0][None, :, None, :] - cb[:, None, :, :]
    d = np.sqrt(np.sum(diff * diff, axis=-1)).min(axis=(1, 2))
    return bool(np.any(d < ra[0] + rb))


def heuristic_initialize(lanelet_map, agent_num: int, rng: random.Random,
                         min_speed: float = 0, max_speed: float = 10,
                         num_attempts_per_agent: int = 500
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """
    Place ``agent_num`` cars on random centerline points without overlaps,
    drawing from ``rng`` (the same draws, in the same order, as the
    reference makes from the global ``random``).

    Returns:
        (agent_attributes 1xAx3 (length, width, lr), agent_states 1xAx4),
        float32 numpy.
    Raises:
        InitializationFailedError when placement cannot be completed.
    """
    longitudinal_gap, lateral_gap = 1.0, 0.2
    attrs, states = [], []
    for _ in range(agent_num):
        for _ in range(num_attempts_per_agent):
            x, y, orientation = pick_random_point_and_orientation(lanelet_map, rng)
            speed = rng.uniform(min_speed, max_speed)
            if states:
                others = np.asarray([
                    [s[0], s[1], CAR_LENGTH + longitudinal_gap,
                     CAR_WIDTH + lateral_gap, s[2]] for s in states])
                me = np.asarray([x, y, CAR_LENGTH, CAR_WIDTH, orientation])
                if _discs_collide(me, others):
                    continue
            attrs.append([CAR_LENGTH, CAR_WIDTH, CAR_LR])
            states.append([x, y, orientation, speed])
            break
        else:
            raise InitializationFailedError()
    if agent_num > 0:
        return (np.asarray(attrs, dtype=np.float32)[None],
                np.asarray(states, dtype=np.float32)[None])
    return np.zeros((1, 0, 3), np.float32), np.zeros((1, 0, 4), np.float32)
