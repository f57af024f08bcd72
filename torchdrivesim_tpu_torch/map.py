"""
Map registry: metadata, lazy asset loading, the baked-grid cache and map
QA (counterpart of ``torchdrivesim_tpu/map.py``). Maps are looked up by name
through ``TDS_RESOURCE_PATH`` plus the maps bundled with the JAX package,
whose baked caches the port reads and never writes: a bake of a bundled map
that lacks one is returned without being cached (:func:`cache_writable`).
``download_iai_map`` needs a network and is not ported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Tuple

import numpy as np

import torchdrivesim_tpu_torch
from torchdrivesim_tpu_torch.mesh import BirdviewMesh
from torchdrivesim_tpu_torch.traffic_controls import (
    BaseTrafficControl, StopSignControl, TrafficLightControl, YieldControl,
)
from torchdrivesim_tpu_torch.traffic_lights import TrafficLightController
from torchdrivesim_tpu_torch.utils import normalize_angle


#: the maps bundled with the JAX package
_BUNDLED_MAPS = os.path.join(torchdrivesim_tpu_torch._REPO_ROOT, 'torchdrivesim_tpu',
                             'resources', 'maps')


def cache_writable(path: Optional[str]) -> bool:
    """Whether a baked cache may be written at ``path``: anywhere but beside
    the maps bundled with the JAX package."""
    return bool(path) and not os.path.abspath(path).startswith(_BUNDLED_MAPS + os.sep)


@dataclass
class Stopline:
    """One stopline entry from ``*_stoplines.json``."""
    actor_id: int
    agent_type: str
    x: float
    y: float
    length: float
    width: float
    orientation: float

    def __post_init__(self):
        aliases = {'traffic-light': 'traffic_light', 'stop-sign': 'stop_sign',
                   'yield-sign': 'yield_sign', 'yield': 'yield_sign'}
        self.agent_type = aliases.get(self.agent_type, self.agent_type)


@dataclass
class MapConfig:
    """Map metadata; file paths may be relative to the map folder."""
    name: str
    left_handed_coordinates: bool = False
    center: Optional[Tuple[float, float]] = None

    lanelet_path: Optional[str] = None
    lanelet_map_origin: Tuple[float, float] = (0, 0)
    mesh_path: Optional[str] = None
    stoplines_path: Optional[str] = None
    traffic_light_controller_path: Optional[str] = None

    iai_location_name: Optional[str] = None
    note: Optional[str] = None

    @property
    def lanelet_map(self):
        """Parsed Lanelet2 map, or None."""
        if self.lanelet_path is None or not os.path.exists(self.lanelet_path):
            return None
        from torchdrivesim_tpu_torch.lanelet2 import load_lanelet_map
        return load_lanelet_map(self.lanelet_path, origin=self.lanelet_map_origin)

    @cached_property
    def road_mesh(self) -> Optional[BirdviewMesh]:
        """The serialized drivable-surface mesh (triangulating a mesh from
        the Lanelet2 map is not ported)."""
        if self.mesh_path is not None and os.path.exists(self.mesh_path):
            return BirdviewMesh.load(self.mesh_path)
        return None

    @property
    def stoplines(self) -> List[Stopline]:
        if self.stoplines_path is None or not os.path.exists(self.stoplines_path):
            return []
        with open(self.stoplines_path, 'r') as f:
            return [Stopline(**d) for d in json.load(f)]

    def traffic_light_controller(self, rng: random.Random
                                 ) -> Optional[TrafficLightController]:
        """The light FSMs, with initial states drawn from ``rng``."""
        if self.traffic_light_controller_path is None or \
                not os.path.exists(self.traffic_light_controller_path):
            return None
        return TrafficLightController.from_json(
            self.traffic_light_controller_path, rng)

    def grids_cache_path(self) -> Optional[str]:
        base = self.mesh_path or self.lanelet_path
        if base is None:
            return None
        return os.path.join(os.path.dirname(base), f'{self.name}_tpu_grids_v2.npz')

    def grids(self, cell_size: float = 0.4, bake_if_missing: bool = True, *, device):
        """
        This map's :class:`MapGrids` on ``device``: read from the cache next
        to the map, or, when it is missing and ``bake_if_missing``, baked
        (``map_grids.bake_map_grids``, the distance field on ``device``) and
        written there; None when it is missing otherwise, or when the map has
        no road mesh to bake from. The cache of a bundled map is not written.
        """
        from torchdrivesim_tpu_torch.map_grids import bake_map_grids, load_map_grids
        cache = self.grids_cache_path()
        if cache and os.path.exists(cache):
            return load_map_grids(cache, device=device)
        if not bake_if_missing:
            return None
        grids = bake_map_grids(self, cell_size=cell_size, device=device)
        if grids is not None and cache_writable(cache):
            try:
                grids.save(cache)
            except OSError:
                pass
        return grids


_PATH_FIELDS = ('lanelet_path', 'mesh_path', 'stoplines_path',
                'traffic_light_controller_path')


def _filename_defaults(name: str) -> Dict[str, str]:
    return dict(
        lanelet_path=f'{name}.osm',
        mesh_path=f'{name}_mesh.json',
        stoplines_path=f'{name}_stoplines.json',
        traffic_light_controller_path=f'{name}_traffic_light_controller.json',
    )


def resolve_paths_to_absolute(cfg: MapConfig, root: str) -> MapConfig:
    """Resolve relative asset paths against the map folder."""
    resolved = {}
    for field, default in _filename_defaults(cfg.name).items():
        existing = getattr(cfg, field) or default
        if os.path.isabs(existing):
            continue
        candidate = os.path.join(root, existing)
        if os.path.exists(candidate):
            resolved[field] = candidate
    return dataclasses.replace(cfg, **resolved)


def load_map_config(json_path: str, resolve_paths: bool = True) -> MapConfig:
    """A ``metadata.json``, its relative paths resolved against its folder
    unless ``resolve_paths`` is False."""
    with open(json_path, 'r') as f:
        cfg = MapConfig(**json.load(f))
    if resolve_paths:
        cfg = resolve_paths_to_absolute(cfg, os.path.dirname(json_path))
    return cfg


def store_map_config(cfg: MapConfig, json_path: str,
                     store_absolute_paths: bool = False) -> None:
    """Write ``cfg`` as a ``metadata.json``, its paths cut to file names
    unless ``store_absolute_paths``."""
    if not store_absolute_paths:
        cfg = dataclasses.replace(cfg, **{
            f: os.path.basename(getattr(cfg, f)) if getattr(cfg, f) else None
            for f in _PATH_FIELDS})
    with open(json_path, 'w') as f:
        json.dump(dataclasses.asdict(cfg), f, indent=4)


def find_map_config(map_name: str, resolve_paths: bool = True) -> Optional[MapConfig]:
    """Locate a map by name across the resource path (names are unique)."""
    for root in torchdrivesim_tpu_torch._resource_path:
        map_path = os.path.join(root, map_name)
        if os.path.exists(map_path):
            break
    else:
        return None
    metadata_path = os.path.join(map_path, 'metadata.json')
    if os.path.exists(metadata_path):
        cfg = load_map_config(metadata_path)
    else:
        cfg = MapConfig(name=map_name)
    if resolve_paths:
        cfg = resolve_paths_to_absolute(cfg, root=map_path)
    return cfg


def list_available_maps() -> List[str]:
    """Names of all maps visible through the resource path."""
    names = []
    for root in torchdrivesim_tpu_torch._resource_path:
        if os.path.isdir(root):
            names += [d for d in sorted(os.listdir(root))
                      if os.path.isdir(os.path.join(root, d))]
    return sorted(set(names))


def find_wrong_way_stoplines(map_cfg: MapConfig,
                             angle_threshold: float = np.pi / 6) -> List[int]:
    """Map QA: the actor ids of stoplines oriented against every lanelet
    direction at their position (none without a Lanelet2 map)."""
    lanelet_map = map_cfg.lanelet_map
    if lanelet_map is None:
        return []
    from torchdrivesim_tpu_torch.lanelet2 import find_lanelet_directions
    wrong = []
    for sl in map_cfg.stoplines:
        directions = find_lanelet_directions(lanelet_map, sl.x, sl.y,
                                             lanelet_dist_tolerance=0)
        if directions and not any(
                abs(normalize_angle(psi - sl.orientation)) < angle_threshold
                for psi in directions):
            wrong.append(sl.actor_id)
    return wrong


def traffic_controls_from_map_config(cfg: MapConfig, *, device
                                     ) -> Dict[str, BaseTrafficControl]:
    """The map's stoplines as controls of batch 1 on ``device``: a
    ``TrafficLightControl``, a ``StopSignControl`` and a ``YieldControl``
    for the kinds the map has, each with the stoplines' ``actor_ids`` in
    file order."""
    classes = {'traffic_light': TrafficLightControl, 'stop_sign': StopSignControl,
               'yield_sign': YieldControl}
    rows = {kind: [] for kind in classes}
    ids = {kind: [] for kind in classes}
    for sl in cfg.stoplines:
        if sl.agent_type in classes:
            rows[sl.agent_type].append([sl.x, sl.y, sl.length, sl.width, sl.orientation])
            ids[sl.agent_type].append(sl.actor_id)
    controls = {}
    for kind, cls in classes.items():
        if rows[kind]:
            control = cls(np.asarray(rows[kind], dtype=np.float32)[None], device=device)
            control.actor_ids = ids[kind]
            controls[kind] = control
    return controls
