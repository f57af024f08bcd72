"""
Batched triangle meshes (counterpart of ``torchdrivesim_tpu/mesh.py``): the
mesh classes with their batch, concatenation, trimming and JSON
(de)serialization operations, the reference's JSON format that
``MapConfig.road_mesh`` loads, the per-camera RGB meshes of the renders,
and the mesh constructors (trajectories, annuli, boxes).

Map meshes are scenario-construction data and stay host numpy: every
operation returns a new mesh. RGB meshes built per frame
(``BirdviewRGBMeshGenerator.generate``) hold tensors, and so do the
single-category meshes built from tensors on the device (sign boxes, lane
markers): :meth:`BirdviewMesh.set_properties` and
:meth:`BirdviewMesh.fill_attr` keep them there.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchdrivesim_tpu_torch.utils import is_inside_polygon

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


def _pad_batch(x: np.ndarray, pad_size: int) -> np.ndarray:
    """``pad_size`` zero batch elements appended."""
    return np.concatenate([x, np.zeros((pad_size,) + x.shape[1:], x.dtype)], axis=0)


def _inside(verts: np.ndarray, polygon) -> np.ndarray:
    """Host (B, V) bool: which vertices lie inside the (B, N, 2) polygon."""
    return is_inside_polygon(torch.from_numpy(np.asarray(verts)),
                             torch.as_tensor(np.asarray(polygon))).numpy()


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
    def dim(self) -> int:
        return self.verts.shape[-1]

    @property
    def batch_size(self) -> int:
        return max(self.verts.shape[0], self.faces.shape[0])

    @property
    def verts_count(self) -> int:
        return self.verts.shape[-2]

    @property
    def faces_count(self) -> int:
        return self.faces.shape[-2]

    @property
    def center(self) -> np.ndarray:
        """Bx2 midpoint of the vertices' bounding box (zeros without any)."""
        if self.verts_count > 0:
            return (self.verts.max(axis=-2) + self.verts.min(axis=-2)) / 2
        return np.zeros((self.batch_size, 2), self.verts.dtype)

    def _replace(self, f) -> "BaseMesh":
        """The mesh with ``f`` applied to each of its per-batch arrays."""
        return dataclasses.replace(self, **{
            name: f(getattr(self, name)) for name in self._batched()})

    @classmethod
    def _batched(cls) -> Tuple[str, ...]:
        return ('verts', 'faces')

    def clone(self) -> "BaseMesh":
        return self._replace(np.copy)

    def expand(self, size: int) -> "BaseMesh":
        """Repeat every batch element ``size`` times contiguously."""
        return self._replace(lambda x: np.repeat(x, size, axis=0))

    def select_batch_elements(self, idx) -> "BaseMesh":
        """The batch elements ``idx`` (an int, list, array or tensor); a
        batch-1 mesh shared by every environment stays as it is."""
        if self.batch_size == 1:
            return self
        idx = _host_index(idx)
        return self._replace(lambda x: x[idx])

    def __getitem__(self, item) -> "BaseMesh":
        return self.select_batch_elements(item)

    def pad(self, pad_size: int) -> "BaseMesh":
        """``pad_size`` empty (all-zero) batch elements appended."""
        return self._replace(lambda x: _pad_batch(x, pad_size))

    def translate(self, xy) -> "BaseMesh":
        """Every batch element's x and y shifted by its row of Bx2 ``xy``."""
        verts = self.verts.copy()
        verts[..., :2] += np.asarray(xy)[:, None, :]
        return dataclasses.replace(self, verts=verts)

    def offset(self, offset) -> "BaseMesh":
        """Every vertex shifted by ``offset``, zero-padded to the mesh's
        dimension."""
        offset = np.asarray(offset)
        if offset.shape[-1] < self.dim:
            offset = np.concatenate([offset, np.zeros(
                offset.shape[:-1] + (self.dim - offset.shape[-1],), offset.dtype)], -1)
        return dataclasses.replace(self, verts=self.verts + offset)

    @classmethod
    def collate(cls, meshes: Sequence["BaseMesh"]) -> "BaseMesh":
        """Batch single-element host meshes, padding with zeros."""
        return cls(verts=_pad_stack([np.asarray(m.verts)[0] for m in meshes], 0.0),
                   faces=_pad_stack([np.asarray(m.faces)[0] for m in meshes], 0))

    @classmethod
    def concat(cls, meshes: Sequence["BaseMesh"]) -> "BaseMesh":
        """One mesh of the given meshes' vertices and faces, in order, each
        one's face indices offset past the vertices before it."""
        offsets = np.concatenate([[0], np.cumsum([m.verts_count for m in meshes])[:-1]])
        return cls(verts=np.concatenate([m.verts for m in meshes], axis=-2),
                   faces=np.concatenate([m.faces + int(off) for m, off in
                                         zip(meshes, offsets)], axis=-2))

    def merge(self, other: "BaseMesh") -> "BaseMesh":
        return self.concat([self, other])

    def serialize(self) -> Dict:
        return {'verts': np.asarray(self.verts).tolist(),
                'faces': np.asarray(self.faces).tolist()}

    def save(self, path: str) -> None:
        """Write the reference's JSON format."""
        folder = os.path.dirname(path)
        if folder:
            os.makedirs(folder, exist_ok=True)
        with open(path, 'w') as f:
            json.dump(self.serialize(), f)

    @classmethod
    def _deserialize_tensors(cls, data: Dict) -> Dict:
        out = dict(data)
        out.update(verts=np.asarray(data['verts'], dtype=np.float32),
                   faces=np.asarray(data['faces'], dtype=np.int32))
        return out

    @classmethod
    def deserialize(cls, data: Dict) -> "BaseMesh":
        return cls(**cls._deserialize_tensors(data))

    @classmethod
    def load(cls, path: str) -> "BaseMesh":
        """Load the reference's JSON mesh format."""
        try:
            with open(path, 'r') as f:
                data = json.load(f)
            return cls.deserialize(data)
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise BadMeshFormat(str(e)) from e

    @classmethod
    def empty(cls, dim: int = 2, batch_size: int = 1) -> "BaseMesh":
        return cls(verts=np.zeros((batch_size, 0, dim), np.float32),
                   faces=np.zeros((batch_size, 0, 3), np.int32))

    def _trim_verts_faces(self, keep_verts: np.ndarray, trim_face_only: bool = False):
        """
        Drop the faces none of whose vertices ``keep_verts`` (B, V) keeps;
        unless ``trim_face_only``, drop the vertices no kept face uses and
        renumber the rest in order. Each batch element is padded to the
        longest (vertices with 0, faces with 0).

        Returns:
            (verts, faces, the kept vertices' old indices (B, Vs) or None).
        """
        faces = np.asarray(self.faces).astype(np.int64)
        kept_faces, kept_verts, kept_idx = [], [], []
        for i in range(self.batch_size):
            fsel = faces[i][keep_verts[i][faces[i]].any(axis=-1)]
            if trim_face_only:
                kept_faces.append(fsel)
                continue
            used = np.unique(fsel)
            remap = np.zeros(max(self.verts_count, 1), dtype=np.int64)
            remap[used] = np.arange(len(used))
            kept_faces.append(remap[fsel])
            kept_verts.append(self.verts[i][used])
            kept_idx.append(used)
        faces_out = _pad_stack([f.astype(np.int32) for f in kept_faces], 0)
        if trim_face_only:
            return self.verts, faces_out, None
        return _pad_stack(kept_verts, 0.0), faces_out, _pad_stack(kept_idx, 0)

    def trim(self, polygon, trim_face_only: bool = False) -> "BaseMesh":
        """The faces with a vertex inside the (B, N, 2) convex polygon, and
        (unless ``trim_face_only``) only the vertices they use."""
        if self.dim != 2:
            raise NotImplementedError("trim only supports 2D meshes")
        verts, faces, _ = self._trim_verts_faces(_inside(self.verts, polygon),
                                                 trim_face_only)
        return BaseMesh(verts=verts, faces=faces)


@dataclass
class AttributeMesh(BaseMesh):
    """Mesh with an attribute vector per vertex: attrs BxVxAttr."""
    attrs: np.ndarray = None

    def __post_init__(self):
        super().__post_init__()
        if self.attrs is not None and self.attrs.ndim == 2:
            self.attrs = self.attrs[None]

    @classmethod
    def _batched(cls) -> Tuple[str, ...]:
        return ('verts', 'faces', 'attrs')

    @property
    def attr_dim(self) -> int:
        return self.attrs.shape[-1]

    @classmethod
    def set_attr(cls, mesh: BaseMesh, attr) -> "AttributeMesh":
        """``mesh`` with the same attribute vector on every vertex."""
        attr = np.asarray(attr)
        return cls(verts=mesh.verts, faces=mesh.faces, attrs=np.broadcast_to(
            attr, mesh.verts.shape[:-1] + attr.shape).copy())

    @classmethod
    def concat(cls, meshes) -> "AttributeMesh":
        base = BaseMesh.concat(meshes)
        return cls(verts=base.verts, faces=base.faces,
                   attrs=np.concatenate([m.attrs for m in meshes], axis=-2))

    @classmethod
    def collate(cls, meshes) -> "AttributeMesh":
        base = BaseMesh.collate(meshes)
        return cls(verts=base.verts, faces=base.faces,
                   attrs=_pad_stack([np.asarray(m.attrs)[0] for m in meshes], 0.0))

    def serialize(self) -> Dict:
        data = super().serialize()
        data['attrs'] = np.asarray(self.attrs).tolist()
        return data

    @classmethod
    def _deserialize_tensors(cls, data: Dict) -> Dict:
        out = super()._deserialize_tensors(data)
        out['attrs'] = np.asarray(data['attrs'], dtype=np.float32)
        return out

    @classmethod
    def empty(cls, dim: int = 2, batch_size: int = 1,
              attr_dim: int = 3) -> "AttributeMesh":
        return cls(verts=np.zeros((batch_size, 0, dim), np.float32),
                   faces=np.zeros((batch_size, 0, 3), np.int32),
                   attrs=np.zeros((batch_size, 0, attr_dim), np.float32))

    def trim(self, polygon, trim_face_only: bool = False) -> "AttributeMesh":
        verts, faces, idx = self._trim_verts_faces(_inside(self.verts, polygon),
                                                   trim_face_only)
        attrs = self.attrs if idx is None else \
            np.take_along_axis(self.attrs, idx[..., None], axis=1)
        return dataclasses.replace(self, verts=verts, faces=faces, attrs=attrs)


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

    @classmethod
    def _batched(cls) -> Tuple[str, ...]:
        return ('verts', 'faces', 'vert_category')

    @property
    def num_categories(self) -> int:
        return len(self.categories)

    def serialize(self) -> Dict:
        data = super().serialize()
        data.update(categories=list(self.categories),
                    colors={k: np.asarray(v).tolist() for k, v in self.colors.items()},
                    zs=self.zs, vert_category=np.asarray(self.vert_category).tolist(),
                    _cat_fill=self._cat_fill)
        return data

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
        """Lift a mesh into a single-category BirdviewMesh: host numpy, or
        tensors on the device of a mesh of tensors."""
        b, v = mesh.batch_size, mesh.verts_count
        if torch.is_tensor(mesh.verts):
            verts, faces = mesh.verts, mesh.faces
            vert_category = torch.zeros((b, v), dtype=torch.int32,
                                        device=mesh.verts.device)
        else:
            verts, faces = np.asarray(mesh.verts), np.asarray(mesh.faces)
            vert_category = np.zeros((b, v), np.int32)
        return cls(verts=verts, faces=faces, categories=[category],
                   colors={category: tensor_color(color)} if color is not None else {},
                   zs={category: z} if z is not None else {},
                   vert_category=vert_category)

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

    @classmethod
    def concat(cls, meshes: Sequence["BirdviewMesh"]) -> "BirdviewMesh":
        """One mesh of the given meshes, in order, on one category list."""
        meshes = cls.unify(meshes)
        base = BaseMesh.concat(meshes)
        first = meshes[0]
        return cls(verts=base.verts, faces=base.faces,
                   categories=first.categories, colors=first.colors, zs=first.zs,
                   vert_category=np.concatenate(
                       [np.asarray(m.vert_category, np.int32) for m in meshes], -1))

    @classmethod
    def empty(cls, dim: int = 2, batch_size: int = 1) -> "BirdviewMesh":
        return cls(verts=np.zeros((batch_size, 0, dim), np.float32),
                   faces=np.zeros((batch_size, 0, 3), np.int32),
                   categories=[], colors={}, zs={},
                   vert_category=np.zeros((batch_size, 0), np.int32))

    def trim(self, polygon, trim_face_only: bool = False) -> "BirdviewMesh":
        verts, faces, idx = self._trim_verts_faces(_inside(self.verts, polygon),
                                                   trim_face_only)
        vc = self.vert_category if idx is None else np.take_along_axis(
            np.asarray(self.vert_category), idx, axis=1).astype(np.int32)
        return dataclasses.replace(self, verts=verts, faces=faces, vert_category=vc)

    def separate_by_category(self) -> Dict[str, BaseMesh]:
        """One :class:`BaseMesh` per category: the faces with a vertex of
        that category and the vertices they use."""
        out = {}
        for i, category in enumerate(self.categories):
            verts, faces, _ = self._trim_verts_faces(
                np.asarray(self.vert_category) == i)
            out[category] = BaseMesh(verts=verts, faces=faces)
        return out

    def fill_attr(self) -> "RGBMesh":
        """Resolve categories to per-vertex colors and to (x, y, z) vertices
        whose z is the rendering priority: host numpy, or for a mesh of
        tensors, tensors on its device (made by fills, no host copy)."""
        missing = [c for c in self.categories
                   if c not in self.colors or c not in self.zs]
        if missing:
            raise RuntimeError(f"Missing colors or z values for categories: {missing}")
        if torch.is_tensor(self.verts):
            return self._fill_attr_tensors()
        cat = np.asarray(self.vert_category, np.int32)
        zs = np.asarray([float(self.zs[k]) for k in self.categories], np.float32)
        table = np.stack([tensor_color(self.colors[k]) for k in self.categories]
                         ).astype(np.float32) if self.categories \
            else np.zeros((0, 3), np.float32)
        verts = np.concatenate([self.verts[..., :2], zs[cat][..., None]], axis=-1)
        return RGBMesh(verts=verts.astype(np.float32), faces=self.faces,
                       attrs=table[cat])

    def _fill_attr_tensors(self) -> "RGBMesh":
        """:meth:`fill_attr` of a mesh of tensors: each category's z and
        color written where its vertices are."""
        xy = self.verts[..., :2].to(torch.float32)
        cat = self.vert_category
        z = xy.new_zeros(xy.shape[:-1])
        rgb = [xy.new_zeros(xy.shape[:-1]) for _ in range(3)]
        for i, k in enumerate(self.categories):
            here = cat == i
            color = tensor_color(self.colors[k])
            z = torch.where(here, float(self.zs[k]), z)
            rgb = [torch.where(here, float(c), x) for c, x in zip(color, rgb)]
        return RGBMesh(verts=torch.cat([xy, z[..., None]], dim=-1),
                       faces=torch.as_tensor(self.faces, device=xy.device).long(),
                       attrs=torch.stack(rgb, dim=-1))


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

    @classmethod
    def set_color(cls, mesh: BaseMesh, color: Color) -> "RGBMesh":
        """``mesh`` (host) with one color on every vertex (``tensor_color``
        of ``color``), as host numpy."""
        rgb = tensor_color(color).astype(mesh.verts.dtype)
        return cls(verts=mesh.verts, faces=mesh.faces, attrs=np.broadcast_to(
            rgb, mesh.verts.shape[:-1] + (3,)).copy())

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


def rendering_mesh(mesh: BaseMesh, category: str) -> BirdviewMesh:
    """``mesh`` as a single-category :class:`BirdviewMesh`."""
    return BirdviewMesh.set_properties(BaseMesh(verts=mesh.verts, faces=mesh.faces),
                                       category=category)


def generate_trajectory_mesh(points, category: Optional[str] = None,
                             edge_length: float = 1.0):
    """
    One equilateral triangle per trajectory point, oriented along it.

    Args:
        points: BxNx3 (x, y, psi).
    Returns:
        a host :class:`BaseMesh` (a :class:`BirdviewMesh` of ``category``
        when given).
    """
    points = np.asarray(points, np.float32)
    angles = np.asarray([0.0, 2 * math.pi / 3, 4 * math.pi / 3], np.float32)
    psi = points[..., 2:3] + angles                                 # B x N x 3
    vx = points[..., 0:1] + np.float32(edge_length * 0.5) * np.cos(psi)
    vy = points[..., 1:2] + np.float32(edge_length * 0.5) * np.sin(psi)
    b, n = points.shape[0], points.shape[1]
    verts = np.stack([vx, vy], axis=-1).reshape(b, n * 3, 2)
    faces = np.broadcast_to(np.arange(n * 3, dtype=np.int32).reshape(1, n, 3),
                            (b, n, 3)).copy()
    mesh = BaseMesh(verts=verts, faces=faces)
    return mesh if category is None else rendering_mesh(mesh, category)


def generate_annulus_polygon_mesh(polygon, scaling_factor: float, origin,
                                  category: Optional[str] = None):
    """
    A batch-1 mesh of the ring between an Nx2 polygon and its copy scaled
    by ``scaling_factor`` about ``origin``: a triangle strip around it that
    wraps at the end.
    """
    polygon = np.asarray(polygon, np.float32)
    center = np.asarray(origin, np.float32)[:2][None]
    outer = (polygon - center) * np.float32(scaling_factor) + center
    verts = np.stack([polygon, outer], axis=1).reshape(-1, 2)
    n_verts = verts.shape[0]
    idx = np.arange(n_verts - 2)
    faces = np.concatenate([
        np.stack([idx, idx + 1, idx + 2], axis=-1),
        np.asarray([[n_verts - 2, n_verts - 1, 0], [n_verts - 1, 0, 1]]),
    ], axis=0).astype(np.int32)
    mesh = BaseMesh(verts=verts[None], faces=faces[None])
    return mesh if category is None else rendering_mesh(mesh, category)


def build_verts_faces_from_bounding_box(bbs, z: float = 2):
    """
    Two triangles per box: ...xAx4x2 corners (numpy or a tensor) to
    (...x4Ax2 vertices, ...x2Ax3 faces) of the same kind; a tensor's faces
    are made on its device (no host copy).
    """
    batch_dims = tuple(bbs.shape[:-3])
    n = bbs.shape[-3]
    verts = bbs.reshape(batch_dims + (n * 4, 2))
    if torch.is_tensor(bbs):
        o = 4 * torch.arange(n, dtype=torch.int32, device=bbs.device)
        faces = torch.stack([o, o + 1, o + 3, o + 1, o + 3, o + 2], dim=-1)
        return verts, faces.reshape(n * 2, 3).expand(batch_dims + (n * 2, 3))
    base = np.asarray([[0, 1, 3], [1, 3, 2]], dtype=np.int32)
    faces = (base[None] + (4 * np.arange(n, dtype=np.int32))[:, None, None]
             ).reshape(n * 2, 3)
    return verts, np.broadcast_to(faces, batch_dims + (n * 2, 3)).copy()
