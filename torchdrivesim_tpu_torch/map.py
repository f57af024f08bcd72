"""
Map registry: metadata, lazy asset loading and the baked-grid cache
(counterpart of ``torchdrivesim_tpu/map.py``). Maps are looked up by name
through ``TDS_RESOURCE_PATH`` plus the maps bundled with the JAX package.
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

    def grids(self, *, device):
        """This map's baked :class:`MapGrids`, read from the cache the JAX
        package wrote next to the map (baking is not ported)."""
        from torchdrivesim_tpu_torch.map_grids import load_map_grids
        cache = self.grids_cache_path()
        if not cache or not os.path.exists(cache):
            raise FileNotFoundError(
                f"no baked grid cache for map {self.name!r} ({cache}); bake it "
                "with the JAX package (its MapConfig.grids)")
        return load_map_grids(cache, device=device)


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


def find_map_config(map_name: str) -> Optional[MapConfig]:
    """Locate a map by name across the resource path."""
    for root in torchdrivesim_tpu_torch._resource_path:
        map_path = os.path.join(root, map_name)
        if os.path.exists(map_path):
            break
    else:
        return None
    metadata_path = os.path.join(map_path, 'metadata.json')
    if os.path.exists(metadata_path):
        with open(metadata_path, 'r') as f:
            cfg = MapConfig(**json.load(f))
    else:
        cfg = MapConfig(name=map_name)
    return resolve_paths_to_absolute(cfg, root=map_path)


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
