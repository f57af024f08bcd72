"""
INTERACTION Dataset v1.2 loading for imitation learning (counterpart of
``torchdrivesim_tpu/behavior/interaction.py``).

A dataset root is laid out as::

    {root}/maps/{location}.osm
    {root}/{split}/{location}_{split}.csv   # case_id / track_id / frame_id rows

Each item is one case around an ego vehicle track of 40 frames: dense
padded host arrays of the case's agents, and the location's road and
lane-marking meshes. :meth:`INTERACTIONDataset.collate` pads per agent type
across a batch, returns the agent arrays as tensors on a device and
collates the meshes, so a batch can mix locations. The CSV files are read
with the standard library; ids keep the order in which they first appear
in a file, frames are sorted.
"""
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from torchdrivesim_tpu_torch.behavior.common import numeric_column, read_csv_columns
from torchdrivesim_tpu_torch.lanelet2 import (
    lanelet_map_to_lane_mesh, load_lanelet_map, road_mesh_from_lanelet_map,
)
from torchdrivesim_tpu_torch.mesh import BirdviewMesh

#: dataset agent types, in tensor order
AGENT_TYPE_NAMES = ['vehicle', 'pedestrian']
#: frames of an ego track
EGO_FRAMES = 40
_NUMERIC = ('case_id', 'track_id', 'frame_id', 'x', 'y', 'vx', 'vy', 'psi_rad',
            'length', 'width')
#: values of empty fields, and the dataset's type names renamed
_FILL = {'psi_rad': 0.0, 'length': 1.5, 'width': 1.5}
_RENAME = {'car': 'vehicle', 'pedestrian/bicycle': 'pedestrian'}


def _in_order(values: np.ndarray) -> np.ndarray:
    """The distinct values in the order of their first appearance."""
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def read_recording(path: str) -> Dict[str, np.ndarray]:
    """A location's CSV as columns: the numeric ones with empty psi,
    length and width filled (0, 1.5, 1.5), ``agent_type`` with 'car' and
    'pedestrian/bicycle' renamed to 'vehicle' and 'pedestrian'."""
    text = read_csv_columns(path)
    cols = {k: numeric_column(text[k]) for k in _NUMERIC}
    for k, fill in _FILL.items():
        cols[k] = np.where(np.isnan(cols[k]), fill, cols[k]) \
            if cols[k].dtype.kind == 'f' else cols[k]
    cols['agent_type'] = np.asarray([_RENAME.get(v, v) for v in text['agent_type']])
    return cols


class INTERACTIONDataset:
    """
    Map-style dataset of ego-centric cases: one segment per vehicle track
    of 40 frames, enumerated by case and then by track in the order they
    first appear in the location's file.
    """
    agent_type_names = AGENT_TYPE_NAMES

    def __init__(self, dataset_path: str,
                 location_names: Optional[List[str]] = None, split: str = 'train'):
        self.split = split
        self.location_names: List[str] = []
        self.road_meshes: Dict[str, BirdviewMesh] = {}
        self.lane_meshes: Dict[str, BirdviewMesh] = {}
        suffix = f'_{split}.csv'
        for fname in sorted(os.listdir(os.path.join(dataset_path, split))):
            if not fname.endswith(suffix):
                continue
            name = fname[:-len(suffix)]
            if location_names is not None and name not in location_names:
                continue
            self.location_names.append(name)
            lanelet_map = load_lanelet_map(os.path.join(dataset_path, 'maps',
                                                        name + '.osm'))
            self.road_meshes[name] = BirdviewMesh.set_properties(
                road_mesh_from_lanelet_map(lanelet_map), 'road')
            self.lane_meshes[name] = lanelet_map_to_lane_mesh(lanelet_map)

        self.idx2segment: List[dict] = []
        self.recordings: List[Dict[str, np.ndarray]] = []
        for location in self.location_names:
            cols = read_recording(os.path.join(dataset_path, split, location + suffix))
            self.recordings.append(cols)
            for case_id in _in_order(cols['case_id']):
                rows = np.nonzero(cols['case_id'] == case_id)[0]
                tracks = cols['track_id'][rows]
                for track_id in _in_order(tracks):
                    track_rows = rows[tracks == track_id]
                    if (cols['agent_type'][track_rows[0]] != 'vehicle'
                            or len(track_rows) != EGO_FRAMES):
                        continue
                    self.idx2segment.append({
                        'location': location,
                        'recording_idx': len(self.recordings) - 1,
                        'case_id': case_id,
                        'ego_track_id': track_id,
                    })

    def subsample(self, num_segments: int = 50, seed: int = 0
                  ) -> "INTERACTIONDataset":
        """Keep ``num_segments`` segments drawn without replacement by
        ``np.random.default_rng(seed)``, in their order."""
        rng = np.random.default_rng(seed=seed)
        num_segments = min(num_segments, len(self))
        keep = set(rng.choice(len(self), num_segments, replace=False).tolist())
        self.idx2segment = [s for i, s in enumerate(self.idx2segment) if i in keep]
        return self

    def __len__(self) -> int:
        return len(self.idx2segment)

    def __getitem__(self, idx: int) -> dict:
        """
        One case as host arrays: ``agent_attributes`` (A, 2) length and
        width, ``agent_states`` (A, T, 4) x, y, psi, speed,
        ``present_mask`` (A, T), ``agent_types`` (A,) int32 (the ego first,
        then the other vehicles, then the pedestrians), ``location``, and
        the location's ``road_mesh`` and ``lane_mesh``.
        """
        seg = self.idx2segment[idx]
        cols = self.recordings[seg['recording_idx']]
        case = {k: v[cols['case_id'] == seg['case_id']] for k, v in cols.items()}
        frame_ids, ti = np.unique(case['frame_id'], return_inverse=True)
        agent_ids, agent_types = [], []
        for type_i, type_name in enumerate(self.agent_type_names):
            ids = list(_in_order(case['track_id'][case['agent_type'] == type_name]))
            if type_name == 'vehicle':
                ids = [seg['ego_track_id']] + [i for i in ids if i != seg['ego_track_id']]
            agent_ids += ids
            agent_types += [type_i] * len(ids)
        a, t = len(agent_ids), len(frame_ids)
        id_index = {aid: i for i, aid in enumerate(agent_ids)}
        ai = np.asarray([id_index[v] for v in case['track_id']], dtype=np.int64)

        states = np.zeros((a, t, 4), dtype=np.float32)
        present = np.zeros((a, t), dtype=bool)
        attrs = np.zeros((a, 2), dtype=np.float32)
        states[ai, ti, 0] = case['x']
        states[ai, ti, 1] = case['y']
        states[ai, ti, 2] = case['psi_rad']
        states[ai, ti, 3] = np.hypot(case['vx'], case['vy'])
        present[ai, ti] = True
        attrs[ai, 0] = case['length']
        attrs[ai, 1] = case['width']
        return {
            'agent_attributes': attrs,
            'agent_states': states,
            'present_mask': present,
            'agent_types': np.asarray(agent_types, dtype=np.int32),
            'location': seg['location'],
            'road_mesh': self.road_meshes[seg['location']],
            'lane_mesh': self.lane_meshes[seg['location']],
        }

    @classmethod
    def collate(cls, items: List[dict], device='cuda') -> dict:
        """
        A batch of items: each type's agents padded (zeros, absent) to that
        type's largest count in the batch and the type blocks concatenated
        along the agent axis, so ``agent_types`` (A,) is the batch's;
        ``agent_attributes`` (B, A, 2), ``agent_states`` (B, A, T, 4),
        ``present_mask`` (B, A, T) and ``agent_types`` as tensors on
        ``device``; the road and lane meshes collated into padded host
        meshes of batch B; ``location`` a list.
        """
        n_types = len(cls.agent_type_names)
        max_per_type = [max(int((item['agent_types'] == i).sum()) for item in items)
                        for i in range(n_types)]

        def pad_cat(key):
            rows = []
            for item in items:
                blocks = []
                for i in range(n_types):
                    block = item[key][item['agent_types'] == i]
                    pad = max_per_type[i] - block.shape[0]
                    blocks.append(np.concatenate(
                        [block, np.zeros((pad,) + block.shape[1:], block.dtype)]))
                rows.append(np.concatenate(blocks, axis=0))
            return torch.as_tensor(np.stack(rows, axis=0), device=device)

        batch = {k: pad_cat(k) for k in ('agent_attributes', 'agent_states',
                                         'present_mask')}
        batch['agent_types'] = torch.as_tensor(np.concatenate(
            [np.full(max_per_type[i], i, np.int32) for i in range(n_types)]),
            device=device)
        batch['road_mesh'] = BirdviewMesh.collate([item['road_mesh'] for item in items])
        batch['lane_mesh'] = BirdviewMesh.collate([item['lane_mesh'] for item in items])
        batch['location'] = [item['location'] for item in items]
        return batch
