"""
Batched triangle meshes (counterpart of ``torchdrivesim_tpu/mesh.py``; the
classes, the reference JSON loader that ``MapConfig.road_mesh`` needs, and
the per-camera RGB meshes of the differentiable render).

Map meshes are scenario-construction data and stay host numpy. RGB meshes
built per frame (``BirdviewRGBMeshGenerator.generate``) hold tensors.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Color = Union[np.ndarray, Tuple[int, int, int], List[int]]


def tensor_color(color: Color) -> np.ndarray:
    """Float (3,) color in [0, 1]: int tuples are 0-255 RGB, arrays are
    taken as already in [0, 1]."""
    if isinstance(color, np.ndarray):
        return np.asarray(color, dtype=np.float32)
    return np.asarray(color, dtype=np.float32) / 255.0


class BadMeshFormat(RuntimeError):
    """Mesh data on disk had the wrong format."""


def _host_index(idx) -> np.ndarray:
    """A batch selection as a host int64 index array (batch dim kept)."""
    if torch.is_tensor(idx):
        idx = idx.cpu().numpy()
    return np.asarray(idx, dtype=np.int64).reshape(-1) if np.ndim(idx) == 0 \
        else np.asarray(idx, dtype=np.int64)


def _pad_stack(arrays: List[np.ndarray], fill) -> np.ndarray:
    """Stack variable-length arrays along a new batch dim with padding."""
    max_len = max(a.shape[0] for a in arrays)
    out = np.full((len(arrays), max_len) + arrays[0].shape[1:], fill,
                  dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    return out


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

    @property
    def verts_count(self) -> int:
        return self.verts.shape[-2]

    def expand(self, size: int) -> "BaseMesh":
        """Repeat every batch element ``size`` times contiguously."""
        return dataclasses.replace(
            self, verts=np.repeat(self.verts, size, axis=0),
            faces=np.repeat(self.faces, size, axis=0))

    def select_batch_elements(self, idx) -> "BaseMesh":
        """The batch elements ``idx`` (an int, list, array or tensor); a
        batch-1 mesh shared by every environment stays as it is."""
        if self.batch_size == 1:
            return self
        idx = _host_index(idx)
        return dataclasses.replace(self, verts=self.verts[idx], faces=self.faces[idx])

    def __getitem__(self, item) -> "BaseMesh":
        return self.select_batch_elements(item)

    @classmethod
    def collate(cls, meshes: Sequence["BaseMesh"]) -> "BaseMesh":
        """Batch single-element host meshes, padding with zeros."""
        return cls(verts=_pad_stack([np.asarray(m.verts)[0] for m in meshes], 0.0),
                   faces=_pad_stack([np.asarray(m.faces)[0] for m in meshes], 0))

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

    def select_batch_elements(self, idx) -> "BirdviewMesh":
        if self.batch_size == 1:
            return self
        base = super().select_batch_elements(idx)
        return dataclasses.replace(
            base, vert_category=self.vert_category[_host_index(idx)])

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

    @classmethod
    def set_properties(cls, mesh: BaseMesh, category: str,
                       color: Optional[Color] = None, z: Optional[float] = None
                       ) -> "BirdviewMesh":
        """Lift a host mesh into a single-category BirdviewMesh."""
        return cls(verts=np.asarray(mesh.verts), faces=np.asarray(mesh.faces),
                   categories=[category],
                   colors={category: tensor_color(color)} if color is not None else {},
                   zs={category: z} if z is not None else {},
                   vert_category=np.zeros((mesh.batch_size, mesh.verts_count),
                                          np.int32))

    @classmethod
    def unify(cls, meshes: Sequence["BirdviewMesh"]) -> List["BirdviewMesh"]:
        """Remap all meshes to one shared, sorted category list."""
        categories = sorted(set().union(*[set(m.categories) for m in meshes]))
        colors = {k: v for m in meshes for k, v in m.colors.items()}
        zs = {k: v for m in meshes for k, v in m.zs.items()}
        out = []
        for m in meshes:
            cat_map = np.asarray([categories.index(c) for c in m.categories] or [0],
                                 dtype=np.int32)
            out.append(dataclasses.replace(
                m, categories=categories, colors=colors, zs=zs,
                vert_category=cat_map[np.asarray(m.vert_category, np.int32)]))
        return out

    @classmethod
    def collate(cls, meshes: Sequence["BirdviewMesh"]) -> "BirdviewMesh":
        """Batch single-element meshes with padding, on one category list."""
        meshes = cls.unify(meshes)
        base = BaseMesh.collate(meshes)
        first = meshes[0]
        return cls(verts=base.verts, faces=base.faces,
                   categories=first.categories, colors=first.colors, zs=first.zs,
                   vert_category=_pad_stack(
                       [np.asarray(m.vert_category)[0] for m in meshes],
                       cls._cat_fill))

    def fill_attr(self) -> "RGBMesh":
        """Resolve categories to per-vertex colors and to (x, y, z) vertices
        whose z is the rendering priority (host numpy)."""
        missing = [c for c in self.categories
                   if c not in self.colors or c not in self.zs]
        if missing:
            raise RuntimeError(f"Missing colors or z values for categories: {missing}")
        cat = np.asarray(self.vert_category, np.int32)
        zs = np.asarray([float(self.zs[k]) for k in self.categories], np.float32)
        table = np.stack([tensor_color(self.colors[k]) for k in self.categories]
                         ).astype(np.float32)
        verts = np.concatenate([self.verts[..., :2], zs[cat][..., None]], axis=-1)
        return RGBMesh(verts=verts.astype(np.float32), faces=self.faces,
                       attrs=table[cat])


@dataclass
class RGBMesh:
    """
    Triangle mesh with an RGB color in [0, 1] per vertex: verts BxVx3
    (x, y, priority z), faces BxFx3, attrs BxVx3: host numpy arrays as
    :meth:`BirdviewMesh.fill_attr` resolves them, tensors after :meth:`to`
    (:meth:`expand` and :meth:`concat` take tensors).
    """
    verts: Union[np.ndarray, torch.Tensor]
    faces: Union[np.ndarray, torch.Tensor]
    attrs: Union[np.ndarray, torch.Tensor]

    @property
    def verts_count(self) -> int:
        return self.verts.shape[-2]

    def expand(self, size: int) -> "RGBMesh":
        """Repeat every batch element ``size`` times contiguously."""
        rep = lambda x: torch.repeat_interleave(x, size, dim=0)
        return RGBMesh(rep(self.verts), rep(self.faces), rep(self.attrs))

    def broadcast_to(self, size: int) -> "RGBMesh":
        """A batch-1 mesh as a batch of ``size`` (views, no copy)."""
        grow = lambda x: x.expand((size,) + tuple(x.shape[1:]))
        return RGBMesh(grow(self.verts), grow(self.faces), grow(self.attrs))

    def to(self, device) -> "RGBMesh":
        """The mesh as tensors on ``device`` (faces int64)."""
        return RGBMesh(torch.as_tensor(self.verts, dtype=torch.float32, device=device),
                       torch.as_tensor(self.faces, device=device).long(),
                       torch.as_tensor(self.attrs, dtype=torch.float32, device=device))

    @classmethod
    def concat(cls, meshes: Sequence["RGBMesh"]) -> "RGBMesh":
        """One scene from several meshes, offsetting face indices."""
        offsets = np.concatenate([[0], np.cumsum([m.verts_count for m in meshes])[:-1]])
        return cls(verts=torch.cat([m.verts for m in meshes], -2),
                   faces=torch.cat([m.faces + int(off) for m, off in zip(meshes, offsets)], -2),
                   attrs=torch.cat([m.attrs for m in meshes], -2))


def set_colors_with_defaults(mesh: BirdviewMesh,
                             color_map: Dict[str, Tuple[int, int, int]],
                             rendering_levels: Dict[str, float]) -> RGBMesh:
    """Fill missing category colors and z values from the defaults and
    resolve the mesh to RGB."""
    colors = dict(mesh.colors)
    zs = dict(mesh.zs)
    for k in mesh.categories:
        colors.setdefault(k, tensor_color(color_map[k]))
        zs.setdefault(k, rendering_levels[k])
    return dataclasses.replace(mesh, colors=colors, zs=zs).fill_attr()


def generate_disc_mesh(radius: float = 2.0, num_triangles: int = 10
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Triangle-fan disc: center vertex + rim vertices. Returns
    (verts (num_triangles+1)x2, faces num_trianglesx3), host numpy."""
    angles = np.linspace(0, 2 * np.pi, num_triangles, endpoint=False)
    rim = np.stack([radius * np.cos(angles), radius * np.sin(angles)], axis=-1)
    verts = np.concatenate([np.zeros((1, 2)), rim], axis=0).astype(np.float32)
    idx = np.arange(num_triangles)
    faces = np.stack([np.zeros_like(idx), idx + 1, (idx + 1) % num_triangles + 1],
                     axis=-1).astype(np.int32)
    return verts, faces
