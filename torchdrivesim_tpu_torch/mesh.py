"""
Batched triangle meshes (counterpart of ``torchdrivesim_tpu/mesh.py``; the
classes and the reference JSON loader that ``MapConfig.road_mesh`` needs).

Meshes are scenario-construction data and stay host numpy: the env step
composites dynamic primitives over a baked texture and never reads them.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

Color = Union[np.ndarray, Tuple[int, int, int], List[int]]


def tensor_color(color: Color) -> np.ndarray:
    """Float (3,) color in [0, 1]: int tuples are 0-255 RGB, arrays are
    taken as already in [0, 1]."""
    if isinstance(color, np.ndarray):
        return np.asarray(color, dtype=np.float32)
    return np.asarray(color, dtype=np.float32) / 255.0


class BadMeshFormat(RuntimeError):
    """Mesh data on disk had the wrong format."""


@dataclass
class BaseMesh:
    """Triangle mesh with one batch dimension: BxVxDim verts, BxFx3 faces."""
    verts: np.ndarray
    faces: np.ndarray

    def __post_init__(self):
        if self.verts.ndim == 2:
            self.verts = self.verts[None]
        if self.faces.ndim == 2:
            self.faces = self.faces[None]

    @property
    def batch_size(self) -> int:
        return max(self.verts.shape[0], self.faces.shape[0])

    def expand(self, size: int) -> "BaseMesh":
        """Repeat every batch element ``size`` times contiguously."""
        return dataclasses.replace(
            self, verts=np.repeat(self.verts, size, axis=0),
            faces=np.repeat(self.faces, size, axis=0))

    @classmethod
    def _deserialize_tensors(cls, data: Dict) -> Dict:
        out = dict(data)
        out.update(verts=np.asarray(data['verts'], dtype=np.float32),
                   faces=np.asarray(data['faces'], dtype=np.int32))
        return out

    @classmethod
    def load(cls, path: str) -> "BaseMesh":
        """Load the reference's JSON mesh format."""
        try:
            with open(path, 'r') as f:
                data = json.load(f)
            return cls(**cls._deserialize_tensors(data))
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise BadMeshFormat(str(e)) from e


@dataclass
class BirdviewMesh(BaseMesh):
    """2D mesh with per-vertex categories plus per-category color and
    rendering priority z."""
    categories: Sequence[str] = dataclasses.field(default_factory=list)
    colors: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    zs: Dict[str, float] = dataclasses.field(default_factory=dict)
    vert_category: np.ndarray = None
    _cat_fill: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.vert_category is not None and self.vert_category.ndim == 1:
            self.vert_category = self.vert_category[None]

    def expand(self, size: int) -> "BirdviewMesh":
        base = super().expand(size)
        return dataclasses.replace(
            base, vert_category=np.repeat(self.vert_category, size, axis=0))

    @classmethod
    def _deserialize_tensors(cls, data: Dict) -> Dict:
        out = super()._deserialize_tensors(data)
        out.update(categories=data['categories'],
                   colors={k: np.asarray(v, dtype=np.float32)
                           for k, v in data['colors'].items()},
                   zs=data['zs'],
                   vert_category=np.asarray(data['vert_category'],
                                            dtype=np.int32),
                   _cat_fill=data.get('_cat_fill', 0))
        return out
