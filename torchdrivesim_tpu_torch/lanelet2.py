"""
Pure-Python Lanelet2 map ingestion (counterpart of
``torchdrivesim_tpu/lanelet2.py``): OSM parsing, WGS84 -> UTM projection
(Karney's transverse-Mercator series), a small lanelet data model, the
random centerline sampler the heuristic initializer uses, the point queries
of the host wrong-way metric (``lanelets_containing``,
``find_lanelet_directions``), the road mesh triangulated from the
lanelets and the lane-marking mesh of their boundaries. Host numpy code,
apart from :class:`LaneFeatures`, the lane feature tensors a simulator
carries.

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
import torch

from torchdrivesim_tpu_torch.mesh import BaseMesh, BirdviewMesh, rendering_mesh
from torchdrivesim_tpu_torch.utils import as_batch_index, host_repeat

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


class Lanelet2NotFound(ImportError):
    """Kept for API parity: this pure-Python implementation needs no native
    lanelet2 package and never raises it."""


class LaneletError(RuntimeError):
    """A lanelet geometric query failed."""


@dataclass
class LaneFeatures:
    """
    Dense and sparse lane feature tensors of a batch of environments, each
    optional: features (B, M, D) with a (B, M) presence mask. The facade's
    noisy render draws each present dense feature (x, y, psi, width, ...)
    as a triangle marker.
    """
    dense_lane_features: Optional[torch.Tensor] = None        #: (B, M, D)
    dense_lane_features_mask: Optional[torch.Tensor] = None   #: (B, M)
    sparse_lane_features: Optional[torch.Tensor] = None       #: (B, N, D)
    sparse_lane_features_mask: Optional[torch.Tensor] = None  #: (B, N)

    def _map(self, f) -> "LaneFeatures":
        return LaneFeatures(*[None if x is None else f(x) for x in (
            self.dense_lane_features, self.dense_lane_features_mask,
            self.sparse_lane_features, self.sparse_lane_features_mask)])

    def to(self, device) -> "LaneFeatures":
        return self._map(lambda x: x.to(device))

    def copy(self) -> "LaneFeatures":
        """A copy sharing the (never written) tensors."""
        return self._map(lambda x: x)

    def extend(self, n: int) -> "LaneFeatures":
        """Every batch element repeated ``n`` times contiguously."""
        return self._map(lambda x: host_repeat(x, n))

    def select_batch_elements(self, idx) -> "LaneFeatures":
        return self._map(lambda x: x[as_batch_index(idx, x.device)])


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

    def polygon(self) -> np.ndarray:
        """Closed boundary polygon: left bound, then the right bound reversed."""
        return np.concatenate([self.left_bound.coords(),
                               self.right_bound.coords()[::-1]], axis=0)

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


def _point_polygon_distance(p: np.ndarray, poly: np.ndarray) -> float:
    """Distance from a point to a polygon's boundary; 0 inside."""
    if _point_in_polygon(p, poly):
        return 0.0
    a = poly
    ab = np.roll(poly, -1, axis=0) - a
    l2 = np.sum(ab * ab, axis=-1)
    t = np.clip(np.sum((p - a) * ab, axis=-1) / np.maximum(l2, 1e-12), 0, 1)
    proj = a + t[:, None] * ab
    return float(np.min(np.linalg.norm(p - proj, axis=-1)))


def _point_in_polygon(p: np.ndarray, poly: np.ndarray) -> bool:
    """Even-odd rule (non-convex lanelets included)."""
    x, y = p
    inside = False
    j = len(poly) - 1
    for i in range(len(poly)):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y):
            if x < (xj - xi) * (y - yi) / (yj - yi) + xi:
                inside = not inside
        j = i
    return inside


def lanelets_containing(lanelet_map: LaneletMap, x: float, y: float,
                        tolerance: float = 1.0) -> List[Lanelet]:
    """Lanelets whose polygon contains (x, y) within ``tolerance`` meters."""
    p = np.asarray([x, y], dtype=np.float64)
    out = []
    for ll in lanelet_map.laneletLayer:
        poly = ll.polygon()
        lo = poly.min(axis=0) - tolerance
        hi = poly.max(axis=0) + tolerance
        if not (lo[0] <= p[0] <= hi[0] and lo[1] <= p[1] <= hi[1]):
            continue
        if _point_polygon_distance(p, poly) <= tolerance:
            out.append(ll)
    return out


def find_direction(linestring: Linestring, location) -> float:
    """
    Local orientation of a linestring near a point: the direction of the
    segment between the two linestring points closest to the point's
    projection. Raises :class:`LaneletError` if those two are not adjacent.
    """
    if len(linestring) < 2:
        raise LaneletError("linestring too short")
    if hasattr(location, 'x'):
        q = np.asarray([location.x, location.y], dtype=np.float64)
    else:
        q = np.asarray(location[:2], dtype=np.float64)
    pts = linestring.coords()
    a, b = pts[:-1], pts[1:]
    ab = b - a
    l2 = np.sum(ab * ab, axis=-1)
    t = np.clip(np.sum((q - a) * ab, axis=-1) / np.maximum(l2, 1e-12), 0, 1)
    proj = a + t[:, None] * ab
    ref = proj[int(np.argmin(np.linalg.norm(q - proj, axis=-1)))]
    order = np.argsort(np.linalg.norm(pts - ref, axis=-1))
    first, second = int(order[0]), int(order[1])
    if abs(first - second) != 1:
        raise LaneletError("Failed to find direction of the linestring at a given point")
    i, j = (second, first) if first > second else (first, second)
    return float(np.arctan2(pts[j][1] - pts[i][1], pts[j][0] - pts[i][0]))


def find_lanelet_directions(lanelet_map: LaneletMap, x: float, y: float,
                            tags_to_exclude: Optional[List[str]] = None,
                            lanelet_dist_tolerance: float = 1.0) -> List[float]:
    """
    Local orientations of every lanelet containing the point. As in the
    reference, an excluded tag on any candidate clears the whole result.
    """
    tags_to_exclude = tags_to_exclude or []
    directions = []
    for ll in lanelets_containing(lanelet_map, x, y, lanelet_dist_tolerance):
        centerline = ll.centerline
        if len(centerline) < 2:
            continue
        if any(tag in ll.attributes for tag in tags_to_exclude):
            return []
        directions.append(find_direction(centerline, (x, y)))
    return directions


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


def line_segments_to_mesh(points: np.ndarray, line_width: float = 0.3,
                          eps: float = 1e-6) -> BaseMesh:
    """
    Line segments thickened into strips of ``2 * line_width``: 6 vertices
    (each endpoint shifted by +-``line_width`` along the normal and
    itself) and 4 faces per segment, in float32.

    Args:
        points: BxNx2x2 segment endpoints.
    """
    points = np.asarray(points, np.float32)
    b, n = points.shape[0], points.shape[1]
    d = points[:, :, 1] - points[:, :, 0]
    d_hat = d / (np.linalg.norm(d, axis=-1, keepdims=True) + np.float32(eps))
    d_perp = np.stack([-d_hat[..., 1], d_hat[..., 0]], axis=-1)[:, :, None]
    width = np.float32(line_width)
    verts = np.concatenate([points + d_perp * width, points, points - d_perp * width],
                           axis=2).reshape(b, n * 6, 2)
    base = np.asarray([[0, 1, 2], [1, 2, 3], [2, 3, 4], [3, 4, 5]], dtype=np.int32)
    faces = (base[None] + (6 * np.arange(n, dtype=np.int32))[:, None, None]
             ).reshape(n * 4, 3)
    return BaseMesh(verts=verts, faces=np.broadcast_to(faces, (b, n * 4, 3)).copy())


def lanelet_map_to_lane_mesh(lanelet_map: LaneletMap, left_handed: bool = False,
                             left_right_marking_join_threshold: float = 0.1,
                             lanelets: Optional[List[int]] = None,
                             lane_boundary_width: float = 0.275) -> BirdviewMesh:
    """
    The lane-marking mesh of a lanelet map (batch 1): every boundary
    segment once, classed 'joint_lane' (a left boundary segment that is
    also a right one, its endpoints equal on the grid of
    ``left_right_marking_join_threshold``), 'left_lane' or 'right_lane'
    (swapped when ``left_handed``), each thickened into a strip.
    """
    left_segments, right_segments = {}, {}
    pts_by_id = {p.id: p for p in lanelet_map.pointLayer}
    for ll in lanelet_map.laneletLayer:
        if lanelets is not None and ll.id not in lanelets:
            continue
        for store, bound in ((left_segments, ll.left_bound),
                             (right_segments, ll.right_bound)):
            for i in range(len(bound) - 1):
                key = tuple(sorted([bound[i].id, bound[i + 1].id]))
                store[key] = key

    def seg_coords(key):
        p1, p2 = pts_by_id[key[0]], pts_by_id[key[1]]
        return np.asarray([[p1.x, p1.y], [p2.x, p2.y]], dtype=np.float32)

    def hash_key(seg: np.ndarray) -> tuple:
        cells = np.round(seg / left_right_marking_join_threshold).astype(np.int64)
        a, b = tuple(cells[0]), tuple(cells[1])
        return (a, b) if a <= b else (b, a)

    left_list = [seg_coords(k) for k in left_segments]
    right_list = [seg_coords(k) for k in right_segments]
    right_hashes = {hash_key(seg) for seg in right_list}
    left_hashes = {hash_key(seg) for seg in left_list}
    joint = [seg for seg in left_list if hash_key(seg) in right_hashes]
    left_only = [seg for seg in left_list if hash_key(seg) not in right_hashes]
    right_only = [seg for seg in right_list if hash_key(seg) not in left_hashes]
    if left_handed:
        left_only, right_only = right_only, left_only

    def to_mesh(segs, category):
        if not segs:
            return BirdviewMesh.empty(dim=2, batch_size=1)
        return rendering_mesh(line_segments_to_mesh(
            np.stack(segs, axis=0)[None], line_width=lane_boundary_width), category)

    return BirdviewMesh.concat([to_mesh(joint, 'joint_lane'),
                                to_mesh(left_only, 'left_lane'),
                                to_mesh(right_only, 'right_lane')])
