"""
Infraction metrics (counterpart of ``torchdrivesim_tpu/infractions.py``;
the disc collision matrix of the env step).
"""
import torch

from torchdrivesim_tpu_torch.ops.collision import collision_matrix_with_discs


def compute_collision_matrix(all_boxes: torch.Tensor, mask: torch.Tensor,
                             metric: str = 'discs') -> torch.Tensor:
    """
    Per-agent collision values against all other agents in one batched op;
    self-overlap is excluded via the diagonal.

    Args:
        all_boxes: Bx(A+Npc)x5; mask: Bx(A+Npc) presence flags.
        metric: 'discs' (the only metric ported so far).
    Returns:
        Bx(A+Npc) summed collision values per agent.
    """
    if metric != 'discs':
        raise NotImplementedError(f"collision metric {metric!r} is not ported")
    boxes = torch.nan_to_num(all_boxes, nan=0.0)
    overlap = collision_matrix_with_discs(boxes)
    overlap = torch.nan_to_num(overlap, nan=0.0)
    n = boxes.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=boxes.device)
    overlap = torch.where(eye, 0.0, overlap)
    overlap = overlap * mask[..., None, :].to(overlap.dtype)
    return overlap.sum(dim=-1)
