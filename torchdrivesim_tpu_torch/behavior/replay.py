"""
NPCs replayed from an INTERACTION recording (counterpart of
``torchdrivesim_tpu/behavior/replay.py``): a track file's segment as
dense (1, A, T, ...) tensors, which :class:`ReplayController` indexes by
the controller clock. The CSV is read with the standard library.
"""
import os
from typing import Tuple

import numpy as np
import torch

from torchdrivesim_tpu_torch.behavior.common import (
    InitializationFailedError, numeric_column, read_csv_columns,
)
from torchdrivesim_tpu_torch.simulator import ReplayController  # noqa: F401

REAR_OFFSET = 1.4  #: fixed rear-axis offset assumed for dataset vehicles


def interaction_replay(location: str, dataset_path: str, initial_frame: int = 1,
                       segment_length: int = 40, recording: int = 0,
                       device='cuda') -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """
    Frames ``initial_frame`` to ``initial_frame + segment_length - 1`` of
    ``recorded_trackfiles/{location}/vehicle_tracks_{recording:03d}.csv``
    under ``dataset_path``: agents in ascending track id, frames in
    ascending frame id, speed ``hypot(vx, vy)``, each agent's length and
    width averaged over its rows.

    Returns:
        (agent attributes (1, A, 3): length, width, rear offset;
         agent states (1, A, T, 4): x, y, psi, speed;
         present mask (1, A, T) bool), on ``device``.
    Raises:
        InitializationFailedError when the first or the last frame is not
        in the recording.
    """
    recording_path = os.path.join(dataset_path, 'recorded_trackfiles', location,
                                  'vehicle_tracks_{:03d}.csv'.format(recording))
    text = read_csv_columns(recording_path)
    cols = {k: numeric_column(text[k]) for k in ('track_id', 'frame_id', 'x', 'y', 'vx',
                                                 'vy', 'psi_rad', 'length', 'width')}
    final_frame = initial_frame + segment_length - 1
    available = set(cols['frame_id'].tolist())
    for frame in (initial_frame, final_frame):
        if frame not in available:
            raise InitializationFailedError(
                f'Frame {frame} not available in {recording_path}')
    rows = (cols['frame_id'] >= initial_frame) & (cols['frame_id'] <= final_frame)
    cols = {k: v[rows] for k, v in cols.items()}
    agent_ids, ai = np.unique(cols['track_id'], return_inverse=True)
    frame_ids, ti = np.unique(cols['frame_id'], return_inverse=True)
    a, t = len(agent_ids), len(frame_ids)

    states = np.zeros((a, t, 4), dtype=np.float32)
    present = np.zeros((a, t), dtype=bool)
    attrs = np.zeros((a, 3), dtype=np.float32)
    attr_counts = np.zeros((a,), dtype=np.int64)
    states[ai, ti, 0] = cols['x']
    states[ai, ti, 1] = cols['y']
    states[ai, ti, 2] = cols['psi_rad']
    states[ai, ti, 3] = np.hypot(cols['vx'], cols['vy'])
    present[ai, ti] = True
    np.add.at(attrs, ai, np.stack([cols['length'], cols['width'],
                                   np.full(len(ai), REAR_OFFSET)], axis=-1))
    np.add.at(attr_counts, ai, 1)
    attrs = (attrs / np.maximum(attr_counts, 1)[:, None]).astype(np.float32)
    as_t = lambda x: torch.as_tensor(x, device=device)[None]
    return as_t(attrs), as_t(states), as_t(present)
