"""
Pure-Python Lanelet2 map ingestion (counterpart of
``torchdrivesim_tpu/lanelet2.py``): OSM parsing, WGS84 -> UTM projection
(Karney's transverse-Mercator series), a small lanelet data model, the
random centerline sampler the heuristic initializer uses, and the road mesh
triangulated from the lanelets. Host numpy code.

The parser keeps the reference parser's lanelet order, so a seeded
``pick_random_point_and_orientation`` picks the same lanelets.
"""
from __future__ import annotations

import math
import random
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from torchdrivesim_tpu_torch.mesh import BaseMesh

_WGS84_A = 6378137.0
_WGS84_F = 1 / 298.257223563
_UTM_K0 = 0.9996
_UTM_FALSE_EASTING = 500000.0


def _tm_series_coefficients():
    n = _WGS84_F / (2 - _WGS84_F)
    big_a = _WGS84_A / (1 + n) * (1 + n ** 2 / 4 + n ** 4 / 64)
    alpha = (
        n / 2 - 2 * n ** 2 / 3 + 5 * n ** 3 / 16,
        13 * n ** 2 / 48 - 3 * n ** 3 / 5,
        61 * n ** 3 / 240,
    )
    return n, big_a, alpha


def utm_forward(lat_deg: np.ndarray, lon_deg: np.ndarray,
                lon0_deg: float) -> Tuple[np.ndarray, np.ndarray]:
    """WGS84 -> transverse Mercator (UTM scale/easting), vectorized."""
    n, big_a, alpha = _tm_series_coefficients()
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float64) - lon0_deg)
    sphi = np.sin(lat)
    t = np.sinh(np.arctanh(sphi) - (2 * math.sqrt(n) / (1 + n))
                * np.arctanh((2 * math.sqrt(n) / (1 + n)) * sphi))
    xi = np.arctan2(t, np.cos(lon))
    eta = np.arcsinh(np.sin(lon) / np.sqrt(t ** 2 + np.cos(lon) ** 2))
    xi_s, eta_s = xi.copy(), eta.copy()
    for j, a_j in enumerate(alpha, start=1):
        xi_s += a_j * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_s += a_j * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    x = _UTM_K0 * big_a * eta_s + _UTM_FALSE_EASTING
    y = _UTM_K0 * big_a * xi_s
    return x, y


def utm_zone_central_meridian(lon_deg: float) -> float:
    zone = int(math.floor((lon_deg + 180) / 6)) + 1
    return zone * 6 - 183.0


@dataclass
class LaneletPoint:
    id: int
    x: float
    y: float


@dataclass
class Linestring:
    """An ordered sequence of points (an OSM way)."""
    id: int
    points: List[LaneletPoint]
    attributes: Dict[str, str] = field(default_factory=dict)

    def __len__(self):
        return len(self.points)

    def __iter__(self):
        return iter(self.points)

    def __getitem__(self, i):
        return self.points[i]

    def coords(self) -> np.ndarray:
        return np.asarray([[p.x, p.y] for p in self.points], dtype=np.float64)


@dataclass
class Lanelet:
    """A drivable lane segment bounded by two linestrings."""
    id: int
    left_bound: Linestring
    right_bound: Linestring
    attributes: Dict[str, str] = field(default_factory=dict)
    _centerline: Optional[Linestring] = None

    @property
    def centerline(self) -> Linestring:
        """Centerline: both bounds resampled by arclength and averaged."""
        if self._centerline is None:
            lb, rb = self.left_bound.coords(), self.right_bound.coords()
            k = max(len(lb), len(rb), 2)
            mid = (_resample_polyline(lb, k) + _resample_polyline(rb, k)) / 2
            self._centerline = Linestring(
                id=-self.id,
                points=[LaneletPoint(id=-1, x=float(p[0]), y=float(p[1]))
                        for p in mid])
        return self._centerline


def _resample_polyline(pts: np.ndarray, k: int) -> np.ndarray:
    if len(pts) == 1:
        return np.repeat(pts, k, axis=0)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=-1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1] if s[-1] > 0 else 1.0
    targets = np.linspace(0, total, k)
    x = np.interp(targets, s, pts[:, 0])
    y = np.interp(targets, s, pts[:, 1])
    return np.stack([x, y], axis=-1)


class _Layer(list):
    """Iterable layer with id lookup, mimicking lanelet2 layers."""
    def __init__(self, items):
        super().__init__(items)
        self._by_id = {it.id: it for it in items}

    def get(self, item_id):
        return self._by_id[item_id]


class LaneletMap:
    """Parsed map: point, linestring, and lanelet layers."""
    def __init__(self, points: List[LaneletPoint], linestrings: List[Linestring],
                 lanelets: List[Lanelet]):
        self.pointLayer = _Layer(points)
        self.lineStringLayer = _Layer(linestrings)
        self.laneletLayer = _Layer(lanelets)


def load_lanelet_map(map_path: str, origin: Tuple[float, float] = (0, 0)) -> LaneletMap:
    """
    Load a Lanelet2 OSM file projected with a UTM projector anchored at
    ``origin``: the output frame is the origin-relative UTM frame.
    """
    root = ET.parse(map_path).getroot()

    ids, lats, lons = [], [], []
    for node in root.iter('node'):
        ids.append(int(node.get('id')))
        lats.append(float(node.get('lat')))
        lons.append(float(node.get('lon')))
    lon0 = utm_zone_central_meridian(origin[1])
    x, y = utm_forward(np.asarray(lats, dtype=np.float64),
                       np.asarray(lons, dtype=np.float64), lon0)
    x0, y0 = utm_forward(np.asarray([origin[0]]), np.asarray([origin[1]]), lon0)
    x = x - x0[0]
    y = y - y0[0]
    points = [LaneletPoint(id=i, x=float(px), y=float(py))
              for i, px, py in zip(ids, x, y)]
    by_id = {p.id: p for p in points}

    linestrings = []
    for way in root.iter('way'):
        refs = [int(nd.get('ref')) for nd in way.findall('nd')]
        tags = {t.get('k'): t.get('v') for t in way.findall('tag')}
        pts = [by_id[r] for r in refs if r in by_id]
        linestrings.append(Linestring(id=int(way.get('id')), points=pts,
                                      attributes=tags))
    ls_by_id = {ls.id: ls for ls in linestrings}

    lanelets = []
    for rel in root.iter('relation'):
        tags = {t.get('k'): t.get('v') for t in rel.findall('tag')}
        if tags.get('type') != 'lanelet':
            continue
        left = right = None
        for member in rel.findall('member'):
            if member.get('type') != 'way':
                continue
            ref = int(member.get('ref'))
            if member.get('role') == 'left':
                left = ls_by_id.get(ref)
            elif member.get('role') == 'right':
                right = ls_by_id.get(ref)
        if left is None or right is None or len(left) < 2 or len(right) < 2:
            continue
        lanelets.append(Lanelet(id=int(rel.get('id')), left_bound=left,
                                right_bound=right, attributes=tags))
    return LaneletMap(points, linestrings, lanelets)


def pick_random_point_and_orientation(lanelet_map: LaneletMap,
                                      rng: random.Random
                                      ) -> Tuple[float, float, float]:
    """Random point along a random lanelet's centerline with its local
    orientation, drawn from ``rng``."""
    ll = rng.choice(list(lanelet_map.laneletLayer))
    pts = ll.centerline.coords()
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=-1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = float(s[-1])
    dist = rng.uniform(0, total)
    x = float(np.interp(dist, s, pts[:, 0]))
    y = float(np.interp(dist, s, pts[:, 1]))
    ahead = min(dist + 1, total)
    x2 = float(np.interp(ahead, s, pts[:, 0]))
    y2 = float(np.interp(ahead, s, pts[:, 1]))
    if ahead == dist:  # zero-length lanelet: fall back to segment direction
        ori = float(np.arctan2(pts[-1][1] - pts[0][1], pts[-1][0] - pts[0][0]))
    else:
        ori = float(np.arctan2(y2 - y, x2 - x))
    return x, y, ori


def road_mesh_from_lanelet_map(lanelet_map: LaneletMap,
                               lanelets: Optional[List[int]] = None) -> BaseMesh:
    """
    Triangulate lanelets into a road-surface mesh: every map point becomes a
    vertex and each lanelet is zipped between its left and right boundary
    polylines (host numpy, batch 1).
    """
    point_index = {p.id: i for i, p in enumerate(lanelet_map.pointLayer)}
    verts = np.asarray([[p.x, p.y] for p in lanelet_map.pointLayer],
                       dtype=np.float32)
    all_faces = []
    for ll in lanelet_map.laneletLayer:
        if lanelets is not None and ll.id not in lanelets:
            continue
        faces = _zipper_triangulate(
            [point_index[p.id] for p in ll.left_bound],
            [point_index[p.id] for p in ll.right_bound])
        if faces:
            all_faces.append(np.asarray(faces, dtype=np.int64))
    faces = np.concatenate(all_faces, axis=0) if all_faces \
        else np.zeros((0, 3), np.int64)
    return BaseMesh(verts=verts[None], faces=faces.astype(np.int32)[None])


def _zipper_triangulate(left: Sequence[int], right: Sequence[int]) -> List[List[int]]:
    """Alternating zipper between two polylines: advance the left and right
    cursors in turn, emitting one triangle per advance."""
    faces = []
    i, j = 0, 0
    n_faces = len(left) + len(right) - 2
    if n_faces < 1:
        return faces
    while i + j < n_faces:
        if i < len(left) - 1:
            faces.append([left[i], right[j], left[i + 1]])
            i += 1
        if j < len(right) - 1 and i + j < n_faces:
            faces.append([left[i], right[j], right[j + 1]])
            j += 1
    return faces
