"""
Geometric tensor helpers shared by the port (counterpart of
``torchdrivesim_tpu/utils.py``; only what the env step uses).
"""
import collections

import numpy as np
import torch

Resolution = collections.namedtuple('Resolution', ['width', 'height'])


def normalize_angle(angle):
    """Normalize angle(s) to the <-pi, pi) range. Works on floats and tensors."""
    return (angle + np.pi) % (2 * np.pi) - np.pi


def rotate(v: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """
    Rotate 2D vectors counterclockwise.

    Args:
        v: (..., 2) points.
        angle: (..., 1) angles in radians, broadcastable against ``v``.
    Returns:
        (..., 2) rotated points.
    """
    c = torch.cos(angle[..., 0])
    s = torch.sin(angle[..., 0])
    x = c * v[..., 0] - s * v[..., 1]
    y = s * v[..., 0] + c * v[..., 1]
    return torch.stack([x, y], dim=-1)


def time_slice(arr: torch.Tensor, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Index a (replay) time axis by a scalar tensor, clamped to range."""
    t = torch.clamp(t.long(), 0, arr.shape[dim] - 1).reshape(1)
    return torch.index_select(arr, dim, t).squeeze(dim)
