"""
The map bakers, the rest of the map stack and the last public-API pieces
on the CPU against the JAX package:

* ``ops.rasterize.bake_background_texture`` (several strips, each one hard
  face raster) and ``benchmark.load_or_bake_texture`` (the float16 cache
  it writes next to a map) against the reference's on small meshes;
* ``ops.grids.bake_distance_field`` (1e-5 m), ``rasterize_triangles_np``
  and its helpers, ``map_grids.bake_map_grids`` and ``MapConfig.grids``
  (bake, write, reload; each package reads the other's cache) on a
  synthetic map written to ``tmp_path``;
* the native direction baker (``native/mapbake.cpp``, built with g++)
  cell for cell against its Python fallback and against the reference's
  ``_bake_direction`` on both paths, as ``tests/test_native_mapbake.py``
  holds the reference's;
* ``load_map_config`` / ``store_map_config``, ``find_map_config``,
  ``list_available_maps`` and ``find_wrong_way_stoplines`` (Town02 and the
  synthetic map);
* the examples ``show_map`` and ``check_map_alignment`` on the synthetic
  map;
* the kinematic, camera, renderer, utility, collision, simulator, mesh,
  lanelet and package-root methods earlier slices skipped.
"""
import dataclasses
import json
import math
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchdrivesim_tpu
import torchdrivesim_tpu_torch
from tests.test_native_mapbake import _curved_map
from tests.test_lanelet2_and_map import _straight_lanelet_map

torch.set_num_threads(1)

M_PER_DEG = 111319.49
TINY = 'tiny_map'


def _port_lanelet_map(jmap):
    """The port's LaneletMap with the same points, ways and lanelets as the
    reference's ``jmap``."""
    from torchdrivesim_tpu_torch import lanelet2 as PL
    pt = lambda p: PL.LaneletPoint(id=p.id, x=p.x, y=p.y)
    ls = lambda s: PL.Linestring(id=s.id, points=[pt(p) for p in s.points],
                                 attributes=dict(s.attributes))
    lines = {s.id: ls(s) for s in jmap.lineStringLayer}
    return PL.LaneletMap(
        [pt(p) for p in jmap.pointLayer], list(lines.values()),
        [PL.Lanelet(id=ll.id, left_bound=lines[ll.left_bound.id],
                    right_bound=lines[ll.right_bound.id], attributes=dict(ll.attributes))
         for ll in jmap.laneletLayer])


def _road_mesh(ys=(-4.0, 4.0), x1=50.0):
    """The synthetic road: a strip along +x, two lane quads (a 'road' and a
    'left_lane' category) and a detached 'road' triangle."""
    from torchdrivesim_tpu_torch.mesh import BaseMesh, BirdviewMesh
    y0, y2 = ys
    road = np.asarray([[0, y0], [x1, y0], [x1, y2], [0, y2], [55, 20], [65, 22], [58, 30]],
                      np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6]], np.int32)
    lane = np.asarray([[0, -0.2], [x1, -0.2], [x1, 0.2], [0, 0.2]], np.float32)
    return BirdviewMesh.concat([
        BirdviewMesh.set_properties(BaseMesh(verts=road, faces=faces), 'road'),
        BirdviewMesh.set_properties(BaseMesh(verts=lane, faces=faces[:2]), 'left_lane')])


def _write_tiny_map(root, name=TINY):
    """A map folder: metadata, the road mesh JSON, a one-lanelet .osm along
    +x (bounds at y = +-4) and two stoplines, one along the lane and one
    against it."""
    folder = os.path.join(root, name)
    os.makedirs(folder, exist_ok=True)
    _road_mesh().save(os.path.join(folder, f'{name}_mesh.json'))
    nodes, ways, nid = [], [], 1
    for wid, ys in ((100, 4.0), (200, -4.0)):
        refs = []
        for x in range(0, 60, 10):
            nodes.append(f'<node id="{nid}" lat="{ys / M_PER_DEG:.10f}" '
                         f'lon="{x / M_PER_DEG:.10f}"/>')
            refs.append(f'<nd ref="{nid}"/>')
            nid += 1
        ways.append(f'<way id="{wid}">{"".join(refs)}</way>')
    with open(os.path.join(folder, f'{name}.osm'), 'w') as f:
        f.write('<?xml version="1.0"?><osm>' + ''.join(nodes) + ''.join(ways)
                + '<relation id="1"><tag k="type" v="lanelet"/>'
                '<member type="way" role="left" ref="100"/>'
                '<member type="way" role="right" ref="200"/></relation></osm>')
    stop = lambda i, x, psi: dict(actor_id=i, agent_type='traffic_light', x=x, y=0.0,
                                  length=1.0, width=6.0, orientation=psi)
    with open(os.path.join(folder, f'{name}_stoplines.json'), 'w') as f:
        json.dump([stop(7, 20.0, 0.0), stop(8, 35.0, math.pi)], f)
    with open(os.path.join(folder, 'metadata.json'), 'w') as f:
        json.dump({'name': name, 'left_handed_coordinates': False,
                   'lanelet_path': f'{name}.osm', 'mesh_path': f'{name}_mesh.json',
                   'stoplines_path': f'{name}_stoplines.json'}, f)
    return folder


@pytest.fixture
def tiny_maps(tmp_path, monkeypatch):
    """Two copies of the synthetic map, one on each package's resource path
    (each package bakes its own caches)."""
    roots = {}
    for label, pkg in (('port', torchdrivesim_tpu_torch), ('jax', torchdrivesim_tpu)):
        root = str(tmp_path / label)
        _write_tiny_map(root)
        monkeypatch.setattr(pkg, '_resource_path', [root] + list(pkg._resource_path))
        roots[label] = root
    return roots


# --- the texture -----------------------------------------------------------------

BAKE_CASES = {
    # the reference's roundtrip square, two strips of 16 rows
    'square': dict(ppm=4.0, margin=8.0, row_chunk=16),
    # random faces of both windings over z ties, strips of 24 rows
    'random': dict(ppm=3.0, margin=5.0, row_chunk=24, random=True),
}


@pytest.mark.parametrize('case', list(BAKE_CASES))
def test_bake_background_texture_matches_jax(case):
    from torchdrivesim_tpu.ops.rasterize import bake_background_texture as jbake
    from torchdrivesim_tpu_torch.ops.rasterize import bake_background_texture
    kw = BAKE_CASES[case]
    if kw.get('random'):
        rng = np.random.RandomState(3)
        verts = np.concatenate([rng.uniform(-12, 12, (60, 2)),
                                rng.randint(0, 3, (60, 1))], -1).astype(np.float32)
        faces = rng.randint(0, 60, (40, 3)).astype(np.int32)
        attrs = rng.rand(60, 3).astype(np.float32)
    else:
        verts = np.asarray([[0., 0., 5.], [10., 0., 5.], [10., 10., 5.], [0., 10., 5.]],
                           np.float32)
        faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
        attrs = np.tile(np.asarray([1.0, 0.0, 0.0], np.float32), (4, 1))
    bg = np.asarray([0.2, 0.3, 0.4], np.float32)
    want = jbake(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs), jnp.asarray(bg),
                 pixels_per_meter=kw['ppm'], margin=kw['margin'], row_chunk=kw['row_chunk'])
    got = bake_background_texture(torch.from_numpy(verts), torch.from_numpy(faces),
                                  torch.from_numpy(attrs), torch.from_numpy(bg),
                                  pixels_per_meter=kw['ppm'], margin=kw['margin'],
                                  row_chunk=kw['row_chunk'])
    assert got.data.shape[0] > kw['row_chunk']                 # several strips
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    assert got.cell_size == want.cell_size
    assert (got.data.numpy() != bg).any(axis=-1).mean() > 0.05


def test_load_or_bake_texture_writes_the_references_cache(tiny_maps):
    from torchdrivesim_tpu.benchmark import load_or_bake_texture as jload
    from torchdrivesim_tpu.map import find_map_config as jfind
    from torchdrivesim_tpu.rendering.base import (
        get_default_color_map, get_default_rendering_levels)
    from torchdrivesim_tpu_torch.benchmark import load_or_bake_texture, texture_cache_path
    from torchdrivesim_tpu_torch.map import find_map_config
    cfg = find_map_config(TINY)
    path = texture_cache_path(cfg, 4.0)
    assert path.startswith(tiny_maps['port']) and not os.path.exists(path)
    got = load_or_bake_texture(cfg, device='cpu')
    assert os.path.exists(path)
    want = jload(jfind(TINY), get_default_color_map(), get_default_rendering_levels())
    np.testing.assert_array_equal(got.data, np.asarray(want.data))
    np.testing.assert_array_equal(got.origin, np.asarray(want.origin))
    with np.load(path) as mine, np.load(texture_cache_path(jfind(TINY), 4.0)) as theirs:
        for key in ('data', 'origin', 'cell'):
            assert mine[key].dtype == theirs[key].dtype
            np.testing.assert_array_equal(mine[key], theirs[key])
    again = load_or_bake_texture(cfg, device='cpu')            # from the cache
    np.testing.assert_array_equal(again.data, got.data.astype(np.float16).astype(np.float32))


# --- the grids ---------------------------------------------------------------------

def test_bake_distance_field_matches_jax():
    from torchdrivesim_tpu.ops.grids import bake_distance_field as jbake
    from torchdrivesim_tpu_torch.ops.grids import bake_distance_field
    mesh = _road_mesh()
    verts, faces = mesh.verts[0], mesh.faces[0]
    want = jbake(verts, faces, cell_size=0.7, margin=6.0, chunk_cells=500, face_chunk=2)
    got = bake_distance_field(verts, faces, cell_size=0.7, margin=6.0, chunk_cells=500,
                              face_chunk=2, device='cpu')
    assert got.data.shape == want.data.shape and got.data.shape[0] * got.data.shape[1] > 1000
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    assert float(got.data.max()) > 5 and float(got.data.min()) == 0


def test_host_triangle_rasterizer_matches_jax():
    from torchdrivesim_tpu.ops import grids as J
    from torchdrivesim_tpu_torch.ops import grids as P
    rng = np.random.RandomState(1)
    verts = rng.uniform(0, 20, (12, 2))
    faces = rng.randint(0, 12, (8, 3))
    values = rng.uniform(-3, 3, 8)
    for tol in (0.0, 0.8):
        want = J.rasterize_triangles_np(verts, faces, values, np.zeros(2), 0.5, 44, 40,
                                        tolerance=tol)
        got = P.rasterize_triangles_np(verts, faces, values, np.zeros(2), 0.5, 44, 40,
                                       tolerance=tol)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[1].max() >= 2
    p = rng.uniform(-2, 22, (50, 2))
    np.testing.assert_array_equal(P._points_near_triangle_np(p, verts[:3], 0.5),
                                  J._points_near_triangle_np(p, verts[:3], 0.5))
    np.testing.assert_array_equal(P._seg_dist_np(p, verts[0], verts[0]),
                                  J._seg_dist_np(p, verts[0], verts[0]))
    np.testing.assert_array_equal(P.grid_coordinates(np.float32([1.5, -2]), 0.4, 3, 5),
                                  J.grid_coordinates(np.float32([1.5, -2]), 0.4, 3, 5))
    for g, w in zip(P.mesh_extent(verts, 3.0), J.mesh_extent(verts, 3.0)):
        np.testing.assert_array_equal(g, w)


def _no_native(monkeypatch, module):
    monkeypatch.setenv('TDS_NO_NATIVE', '1')
    monkeypatch.setattr(module, '_LIB', None)
    monkeypatch.setattr(module, '_LIB_FAILED', False)


@pytest.mark.parametrize('make_map', [_straight_lanelet_map, _curved_map])
def test_direction_bakers_match_each_other_and_jax(make_map, monkeypatch):
    import torchdrivesim_tpu.native as jn
    import torchdrivesim_tpu_torch.native as pn
    from torchdrivesim_tpu.map_grids import _bake_direction as jbake
    from torchdrivesim_tpu.ops.grids import Grid2D as JGrid
    from torchdrivesim_tpu_torch import map_grids as M
    from torchdrivesim_tpu_torch.ops.grids import Grid2D
    if pn._load_library() is None:
        pytest.fail('the native baker did not build (g++ is expected here)')
    jmap = make_map()
    pmap = _port_lanelet_map(jmap)
    origin, h, w = np.asarray([-3.0, -6.0], np.float32), 50, 160
    dist = Grid2D(data=torch.zeros(h, w, 1), origin=torch.from_numpy(origin), cell_size=0.4)
    jdist = JGrid(data=np.zeros((h, w, 1), np.float32), origin=origin, cell_size=0.4)
    before = dict(M.DIRECTION_BAKES)
    native = M._bake_direction(pmap, dist, 0.4, 1.0).data[..., 0]
    want_native = np.asarray(jbake(jmap, jdist, 0.4, 1.0).data)[..., 0]
    _no_native(monkeypatch, pn)
    _no_native(monkeypatch, jn)
    python = M._bake_direction(pmap, dist, 0.4, 1.0).data[..., 0]
    want_python = np.asarray(jbake(jmap, jdist, 0.4, 1.0).data)[..., 0]
    assert M.DIRECTION_BAKES == {'native': before['native'] + 1,
                                 'python': before['python'] + 1}
    np.testing.assert_array_equal(native, want_native)
    np.testing.assert_array_equal(python, want_python)
    assert (native == python).mean() > 0.999
    assert (native != -1).mean() > 0.1
    diff = native != python                  # at most a quantization bin apart
    for shift in (0, 8, 16, 24):
        a = (python[diff].view(np.uint32) >> shift) & 255
        b = (native[diff].view(np.uint32) >> shift) & 255
        assert not ((a == 255) ^ (b == 255)).any()
        delta = np.minimum(np.abs(a.astype(int) - b), 255 - np.abs(a.astype(int) - b))
        assert delta.size == 0 or delta.max() <= 2


def test_points_near_polygon_and_directions_match_jax():
    from torchdrivesim_tpu import map_grids as J
    from torchdrivesim_tpu_torch import map_grids as P
    ll = _curved_map().laneletLayer[1]
    pts = np.random.RandomState(2).uniform(-5, 35, (5000, 2))   # three chunks
    np.testing.assert_array_equal(P._points_near_polygon(pts, ll.polygon(), 1.0),
                                  J._points_near_polygon(pts, ll.polygon(), 1.0))
    np.testing.assert_array_equal(
        P._polyline_directions_at(ll.centerline.coords(), pts),
        J._polyline_directions_at(ll.centerline.coords(), pts))


def test_bake_map_grids_and_the_grid_cache(tiny_maps, monkeypatch):
    from torchdrivesim_tpu.map import find_map_config as jfind
    from torchdrivesim_tpu.map_grids import load_map_grids as jload
    from torchdrivesim_tpu_torch import map_grids as M
    from torchdrivesim_tpu_torch.map import find_map_config
    cfg, jcfg = find_map_config(TINY), jfind(TINY)
    assert cfg.grids(bake_if_missing=False, device='cpu') is None
    before = M.DIRECTION_BAKES['native']
    grids = cfg.grids(cell_size=0.5, device='cpu')           # bakes and writes
    assert M.DIRECTION_BAKES['native'] == before + 1
    jgrids = jcfg.grids(cell_size=0.5)
    np.testing.assert_allclose(grids.distance.data.numpy(), np.asarray(jgrids.distance.data),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(grids.direction.data.numpy(),
                                  np.asarray(jgrids.direction.data))
    np.testing.assert_array_equal(grids.distance.origin.numpy(),
                                  np.asarray(jgrids.distance.origin))
    assert (grids.direction.data != -1).float().mean() > 0.05
    # each package reads the other's cache
    mine, theirs = cfg.grids_cache_path(), jcfg.grids_cache_path()
    assert os.path.exists(mine) and os.path.exists(theirs)
    for path in (mine, theirs):
        by_jax, by_port = jload(path), M.load_map_grids(path, device='cpu')
        for name in ('distance', 'distance_quad', 'direction'):
            np.testing.assert_array_equal(getattr(by_port, name).data.numpy(),
                                          np.asarray(getattr(by_jax, name).data))
    np.testing.assert_allclose(M.load_map_grids(mine, device='cpu').distance.data.numpy(),
                               np.asarray(jload(theirs).distance.data), rtol=0, atol=0.02)
    # the losses read the baked grids as the reference's
    from torchdrivesim_tpu.map_grids import offroad_loss_from_grid as joff
    states = np.asarray([[[10.0, 0.0, 0.0, 1.0], [20.0, 9.0, 3.0, 1.0]]], np.float32)
    lenwid = np.full((1, 2, 2), 2.0, np.float32)
    got = M.offroad_loss_from_grid(grids, torch.from_numpy(states), torch.from_numpy(lenwid))
    np.testing.assert_allclose(got.numpy(), np.asarray(joff(jgrids, states, lenwid)),
                               rtol=1e-5, atol=1e-5)
    assert got[0, 0] == 0 and got[0, 1] > 0
    wrong = M.wrong_way_loss_from_grid(grids, torch.from_numpy(states))
    assert wrong[0, 0] == 0 and wrong[0, 1] == 0
    back = M.wrong_way_loss_from_grid(grids, torch.tensor([[[10.0, 1.0, math.pi, 1.0]]]))
    assert back[0, 0] > 0.9


# --- the map registry --------------------------------------------------------------

def test_map_config_round_trip_and_registry(tiny_maps, tmp_path):
    from torchdrivesim_tpu.map import list_available_maps as jlist
    from torchdrivesim_tpu.map import load_map_config as jload
    from torchdrivesim_tpu_torch import map as M
    folder = os.path.join(tiny_maps['port'], TINY)
    cfg = M.load_map_config(os.path.join(folder, 'metadata.json'))
    assert cfg == M.find_map_config(TINY) and os.path.isabs(cfg.mesh_path)
    raw = M.load_map_config(os.path.join(folder, 'metadata.json'), resolve_paths=False)
    assert raw.mesh_path == f'{TINY}_mesh.json'
    assert dataclasses.asdict(raw) == dataclasses.asdict(
        jload(os.path.join(folder, 'metadata.json'), resolve_paths=False))
    # as the reference's: the metadata's own paths are resolved all the same
    from torchdrivesim_tpu.map import find_map_config as jfind
    strip = lambda c, root: {k: v.replace(root, '') if isinstance(v, str) else v
                             for k, v in dataclasses.asdict(c).items()}
    assert strip(M.find_map_config(TINY, resolve_paths=False), tiny_maps['port']) == \
        strip(jfind(TINY, resolve_paths=False), tiny_maps['jax'])
    out = str(tmp_path / 'stored.json')
    M.store_map_config(cfg, out)
    with open(out) as f:
        stored = json.load(f)
    assert stored['mesh_path'] == f'{TINY}_mesh.json' and stored['name'] == TINY
    shutil.copy(out, os.path.join(folder, 'metadata.json'))
    paths = lambda c: [c.name] + [getattr(c, f) for f in M._PATH_FIELDS]
    assert paths(M.find_map_config(TINY)) == paths(cfg)
    M.store_map_config(cfg, out, store_absolute_paths=True)
    assert M.load_map_config(out, resolve_paths=False).mesh_path == cfg.mesh_path
    names = M.list_available_maps()
    assert names == jlist() and TINY in names and 'carla_Town02' in names
    assert M.find_map_config('no_such_map') is None


def test_bundled_map_caches_are_never_written(tiny_maps, monkeypatch):
    """A bake of a bundled map is returned but not cached beside it; a map
    elsewhere gets its cache."""
    from torchdrivesim_tpu_torch import map as M
    town = M.find_map_config('carla_Town02')
    assert not M.cache_writable(town.grids_cache_path())
    assert not M.cache_writable(None)
    tiny = M.find_map_config(TINY)
    assert M.cache_writable(tiny.grids_cache_path())
    bundled = dataclasses.replace(tiny, name='carla_Town02_baked_here')
    monkeypatch.setattr(M, '_BUNDLED_MAPS', os.path.dirname(os.path.dirname(tiny.mesh_path)))
    assert not M.cache_writable(bundled.grids_cache_path())
    assert bundled.grids(cell_size=0.8, device='cpu') is not None
    assert not os.path.exists(bundled.grids_cache_path())


def test_find_wrong_way_stoplines_matches_jax(tiny_maps):
    from torchdrivesim_tpu.map import find_map_config as jfind
    from torchdrivesim_tpu.map import find_wrong_way_stoplines as jwrong
    from torchdrivesim_tpu_torch.map import find_map_config, find_wrong_way_stoplines
    assert find_wrong_way_stoplines(find_map_config(TINY)) == [8] == jwrong(jfind(TINY))
    town = find_wrong_way_stoplines(find_map_config('carla_Town02'))
    assert town == jwrong(jfind('carla_Town02'))
    from torchdrivesim_tpu_torch.map import MapConfig
    assert find_wrong_way_stoplines(MapConfig(name='none')) == []


# --- the examples ------------------------------------------------------------------

def test_map_examples(tiny_maps, tmp_path):
    from torchdrivesim_tpu.benchmark import load_or_bake_texture as jload
    from torchdrivesim_tpu.map import find_map_config as jfind
    from torchdrivesim_tpu.rendering.base import (
        get_default_color_map, get_default_rendering_levels)
    from torchdrivesim_tpu_torch.examples import check_map_alignment, show_map
    out = str(tmp_path / 'map.npz')
    img = show_map.main(['--map', TINY, '--out', out, '--device', 'cpu'])
    want = jload(jfind(TINY), get_default_color_map(), get_default_rendering_levels())
    np.testing.assert_array_equal(img, (np.asarray(want.data)[::-1] * 255).astype(np.uint8))
    with np.load(out) as data:
        np.testing.assert_array_equal(data['frame'], img)
    road = np.asarray(get_default_color_map()['road'], np.uint8)
    assert (img == road).all(axis=-1).mean() > 0.03
    out = str(tmp_path / 'align.npz')
    img, wrong = check_map_alignment.main(['--map', TINY, '--out', out, '--device', 'cpu'])
    assert wrong == [8]
    red = np.asarray(get_default_color_map()['traffic_light_red'], np.uint8)
    assert (img == red).all(axis=-1).sum() > 10 and img.dtype == np.uint8
    with np.load(out) as data:
        np.testing.assert_array_equal(data['frame'], img)


# --- the rest of the public API ----------------------------------------------------

def test_kinematic_api_matches_jax():
    import torchdrivesim_tpu.kinematic as JK
    import torchdrivesim_tpu_torch.kinematic as K
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 4).astype(np.float32)
    parts = K.unpack_state(torch.from_numpy(x))
    for got, want in zip(parts, JK.unpack_state(jnp.asarray(x))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(K.pack_state(*parts).numpy(), x)
    np.testing.assert_array_equal(K.KinematicModel.pack_state(*parts).numpy(),
                                  np.asarray(JK.KinematicModel.pack_state(
                                      *JK.unpack_state(jnp.asarray(x)))))
    lr = rng.uniform(1, 2, (2, 3)).astype(np.float32)
    m, jm = K.KinematicBicycle(device='cpu'), JK.KinematicBicycle()
    for model in (m, jm):
        model.set_state(x)
        model.set_params(lr=lr)
    assert (m.state_size, m.batch_size) == (jm.state_size, jm.batch_size) == (4, 6)
    for model in (m, jm):
        model.flattening((2, 3))
    assert tuple(m.params.lr.shape) == tuple(jm.params.lr.shape) == (6,)
    for model in (m, jm):
        model.unflattening((2, 3))
        model.map_param(lambda v: v * 2)
    np.testing.assert_array_equal(m.params.lr.numpy(), np.asarray(jm.params.lr))
    assert m.left_handed is False and jm.left_handed is False
    m.left_handed = jm.left_handed = True
    assert m.left_handed and m.params.left_handed and jm.params.left_handed
    assert m.to('cpu') is m and m.state.device.type == 'cpu'
    ids = np.asarray([[1, 3, 4], [3, 3, 1]])
    c, jc = K.CompoundKinematicModel(ids, device='cpu'), JK.CompoundKinematicModel(ids)
    np.testing.assert_array_equal(c.batch_assignments.numpy(), np.asarray(jc.batch_assignments))
    assert c.batch_shape == tuple(jc.batch_shape) == (2, 3)
    assert c.to('cpu').model_assignments.device.type == 'cpu'


def test_cameras_and_renderer_api_match_jax():
    from torchdrivesim_tpu.rendering.base import Cameras as JCams
    from torchdrivesim_tpu.rendering.jax_renderer import JaxRenderer
    from torchdrivesim_tpu_torch.rendering import Renderer, RendererConfig
    from torchdrivesim_tpu_torch.rendering.base import Cameras
    from torchdrivesim_tpu_torch.utils import Resolution
    rng = np.random.RandomState(4)
    xy = rng.uniform(-50, 50, (3, 2)).astype(np.float32)
    psi = rng.uniform(-3, 3, 3)
    sc = np.stack([np.sin(psi), np.cos(psi)], -1).astype(np.float32)
    cams, jcams = Cameras(torch.from_numpy(xy), torch.from_numpy(sc), 0.05), \
        JCams(jnp.asarray(xy), jnp.asarray(sc), 0.05)
    pts = rng.uniform(-60, 60, (3, 5, 2)).astype(np.float32)
    res = Resolution(64, 48)
    close = lambda g, w: np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                                    atol=1e-4)
    close(cams.get_camera_center(), jcams.get_camera_center())
    close(cams.get_world_to_view_transform(), jcams.get_world_to_view_transform())
    close(cams.get_view_to_proj_transform(), jcams.get_view_to_proj_transform())
    close(cams.world_to_clip_transform, jcams.world_to_clip_transform)
    p3 = np.concatenate([pts, np.ones((3, 5, 1), np.float32)], -1)
    close(cams.project_world_to_clip_space(torch.from_numpy(p3)),
          jcams.project_world_to_clip_space(jnp.asarray(p3)))
    screen = cams.transform_points_screen(torch.from_numpy(pts), res)
    close(screen, jcams.transform_points_screen(jnp.asarray(pts), res))
    close(cams.reverse_transform_points_screen(screen, res),
          jcams.reverse_transform_points_screen(jnp.asarray(screen.numpy()), res))
    close(cams.reverse_transform_points_screen(screen, res), pts)
    renderer = Renderer(RendererConfig(), 'cpu', res=Resolution(32, 32), fov=50)
    renderer.color_map['road'] = (1, 2, 3)
    other = renderer.copy()
    assert type(other) is Renderer and other.cfg == renderer.cfg and other is not renderer
    assert other.color_map == renderer.color_map and other.color_map is not renderer.color_map
    assert (other.scale, other.res) == (renderer.scale, renderer.res)
    jr = JaxRenderer(other.cfg, color_map=dict(other.color_map), res=other.res, fov=50)
    assert jr.copy().scale == other.scale
    made = renderer.construct_cameras(cams.xy, cams.sc)
    jmade = jr.construct_cameras(jcams.xy, jcams.sc)
    assert made.scale == jmade.scale == renderer.scale
    assert renderer.construct_cameras(cams.xy, cams.sc, 0.3).scale == 0.3


def test_utils_collision_and_simulator_api_match_jax():
    from torchdrivesim_tpu import utils as JU
    from torchdrivesim_tpu.ops.collision import collision_detection_with_discs as jcoll
    from torchdrivesim_tpu_torch import utils as U
    from torchdrivesim_tpu_torch.ops.collision import collision_detection_with_discs
    from torchdrivesim_tpu_torch.simulator import CompoundNPCController, Simulator
    rng = np.random.RandomState(5)
    theta = rng.uniform(-4, 4, (4, 1)).astype(np.float32)
    np.testing.assert_allclose(U.rotation_matrix(torch.from_numpy(theta)).numpy(),
                               np.asarray(JU.rotation_matrix(jnp.asarray(theta))),
                               rtol=1e-6, atol=1e-6)
    p1, p2, c = (rng.uniform(-3, 3, (50, 2)).astype(np.float32) for _ in range(3))
    r = rng.uniform(0.1, 2, (50, 1)).astype(np.float32)
    got = U.line_circle_intersection(*map(torch.from_numpy, (p1, p2, c, r))).numpy()
    np.testing.assert_array_equal(got, np.asarray(JU.line_circle_intersection(
        *map(jnp.asarray, (p1, p2, c, r)))))
    assert got.shape == (50, 1) and 0 < got.mean() < 1
    ds = [{'a': 1, 'b': 2}, {'b': 3}, {'c': 4}]
    assert U.merge_dicts(ds) == JU.merge_dicts(ds) == {'a': 1, 'b': 3, 'c': 4}
    boxes = np.concatenate([rng.uniform(-4, 4, (2, 6, 2)), rng.uniform(1, 5, (2, 6, 2)),
                            rng.uniform(-3, 3, (2, 6, 1))], -1).astype(np.float32)
    got = collision_detection_with_discs(torch.from_numpy(boxes[0]), torch.from_numpy(boxes[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jcoll(jnp.asarray(boxes[0]),
                                                             jnp.asarray(boxes[1]))),
                               rtol=1e-5, atol=1e-6)
    assert got.shape == (6,) and (got > 0).any() and (got == 0).any()
    assert CompoundNPCController.gather_npc_states(None) is None
    assert Simulator.validate_agent_types(None) is None


def test_mesh_lanelet_and_root_api(tmp_path):
    from torchdrivesim_tpu.mesh import BaseMesh as JBase, BirdviewMesh as JMesh
    from torchdrivesim_tpu_torch.mesh import BaseMesh, BirdviewMesh, RGBMesh
    mesh = _road_mesh()
    assert mesh.device is None and mesh.to('cpu') is mesh
    assert BaseMesh(verts=torch.zeros(1, 3, 2), faces=torch.zeros(1, 1, 3)).device == \
        torch.device('cpu')
    path = str(tmp_path / 'sub' / 'mesh.pkl')
    mesh.pickle(path)
    back = BaseMesh.unpickle(path)
    theirs = JMesh.unpickle(path)
    assert type(back) is BirdviewMesh and type(theirs) is JMesh
    for name in ('verts', 'faces', 'vert_category'):
        np.testing.assert_array_equal(getattr(back, name), getattr(mesh, name))
        np.testing.assert_array_equal(np.asarray(getattr(theirs, name)), getattr(mesh, name))
    assert back.categories == list(theirs.categories) == list(mesh.categories)
    jpath = str(tmp_path / 'j.pkl')
    JBase(verts=np.ones((1, 3, 2), np.float32), faces=np.zeros((1, 1, 3), np.int32)
          ).pickle(jpath)
    got = BaseMesh.unpickle(jpath)
    assert type(got) is BaseMesh and np.array_equal(got.verts, np.ones((1, 3, 2)))
    rgb_path = str(tmp_path / 'rgb.pkl')
    rgb = RGBMesh(torch.ones(1, 3, 3), torch.zeros(1, 1, 3, dtype=torch.long),
                  torch.ones(1, 3, 3))
    BaseMesh.pickle(rgb, rgb_path)
    assert type(BaseMesh.unpickle(rgb_path)) is RGBMesh
    jmap = _straight_lanelet_map()
    pmap = _port_lanelet_map(jmap)
    for ll, jll in zip(pmap.laneletLayer, jmap.laneletLayer):
        assert ll.leftBound is ll.left_bound and ll.rightBound is ll.right_bound
        assert [p.point_2d for p in ll.leftBound] == [p.point_2d for p in jll.leftBound]
    assert torchdrivesim_tpu_torch.assert_pytorch3d_available() is None
