"""
Stop and yield signs, on the CPU, against the JAX package.

* ``traffic_controls_from_map_config`` on Town07 ({light 18, stop 18,
  yield 20}) and Town10HD ({light 30, stop 2, yield 1}): the kinds, the
  counts, the stoplines, the corners (1e-4 m: sin and cos of the two
  packages may round apart) and the ``actor_ids``, equal to the reference's.
* An untextured Town10HD frame (res 48, fov 20 m, B = 2, 2 agents) centred
  on each stop sign and on the yield sign, the road mesh trimmed to 30 m
  about the camera: the port's plain chunked hard raster under the three
  roundings of ``warp.affine`` against the reference's kernel in Pallas
  interpret mode (``_on_tpu`` patched), 0 pixels off beyond the rounding;
  each sign's pixels present in its own color.
* The textured primitive frame (the fused render, B1) does not draw signs,
  as the reference's ``generate_prims`` does not: with the signs it is bit
  for bit the frame without them.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_warp_nearest import judge_roundings

torch.set_num_threads(1)

KINDS = ('traffic_light', 'stop_sign', 'yield_sign')
COUNTS = {'carla_Town07': (18, 18, 20), 'carla_Town10HD': (30, 2, 1)}
RES, FOV, TRIM = 48, 20.0, 30.0


@pytest.mark.parametrize('name', sorted(COUNTS))
def test_controls_from_map_config_match_jax(name):
    from torchdrivesim_tpu.map import (
        find_map_config as jfind, traffic_controls_from_map_config as jcontrols)
    from torchdrivesim_tpu_torch.map import (
        find_map_config, traffic_controls_from_map_config)
    want = jcontrols(jfind(name))
    got = traffic_controls_from_map_config(find_map_config(name), device='cpu')
    assert sorted(got) == sorted(want) == sorted(KINDS)
    assert tuple(got[k].corners.shape[1] for k in KINDS) == COUNTS[name]
    for kind in KINDS:
        assert type(got[kind]).__name__ == type(want[kind]).__name__
        assert got[kind].actor_ids == want[kind].actor_ids
        np.testing.assert_array_equal(got[kind].pos.numpy(), np.asarray(want[kind].pos))
        np.testing.assert_allclose(got[kind].corners.numpy(),
                                   np.asarray(want[kind].corners), rtol=0, atol=1e-4)
        assert got[kind].allowed_states == want[kind].allowed_states


def _signs(cfg):
    return [sl for sl in cfg.stoplines if sl.agent_type in ('stop_sign', 'yield_sign')]


@pytest.fixture(scope='module')
def town10():
    """The benchmark world on Town10HD (B = 2, 2 agents, no texture) in
    both packages, the JAX kernels in interpret mode for the module."""
    import torchdrivesim_tpu.ops.pallas_fused as F
    import torchdrivesim_tpu.ops.pallas_rasterize as R
    import torchdrivesim_tpu.ops.pallas_warp as W
    import torchdrivesim_tpu.rendering.jax_renderer as jr
    from torchdrivesim_tpu.benchmark import build_benchmark_scenario as jbuild
    from torchdrivesim_tpu_torch.benchmark import build_benchmark_scenario
    kw = dict(map_name='carla_Town10HD', batch_size=2, agent_count=2, res=RES, fov=FOV,
              use_texture=False, n_layouts=2)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jr, '_on_tpu', lambda: True)
        for mod in (W, R, F):
            m.setattr(mod.pl, 'pallas_call',
                      functools.partial(mod.pl.pallas_call, interpret=True))
        yield jbuild(**kw).sim, build_benchmark_scenario(device='cpu', **kw).sim


@pytest.mark.parametrize('sign', [0, 1, 2])
def test_untextured_frame_on_a_sign_matches_jax(town10, sign):
    from torchdrivesim_tpu.map import find_map_config as jfind
    from torchdrivesim_tpu_torch.map import find_map_config
    jsim, psim = town10
    cfg = find_map_config('carla_Town10HD')
    sl = _signs(cfg)[sign]
    center = np.asarray([sl.x, sl.y], np.float32)
    box = np.asarray([center + [-TRIM, -TRIM], center + [TRIM, -TRIM],
                      center + [TRIM, TRIM], center + [-TRIM, TRIM]], np.float32)
    jsim = jsim.copy()
    psim = psim.copy()
    jsim.birdview_mesh_generator.initialize_background_mesh(
        jfind('carla_Town10HD').road_mesh.trim(jnp.asarray(box)).expand(2))
    psim.birdview_mesh_generator.initialize_background_mesh(cfg.road_mesh.trim(box))
    xy = np.repeat(center[None, None], 2, axis=0)
    psi = np.full((2, 1, 1), 0.3, np.float32)
    want = np.asarray(jsim.render(jnp.asarray(xy), jnp.asarray(psi), fov=FOV))
    render = lambda: psim.render(torch.from_numpy(xy), torch.from_numpy(psi),
                                 fov=FOV).numpy()
    assert judge_roundings(render, want, f'{sl.agent_type} {sl.actor_id}') == 0
    color = np.asarray(psim.renderer.color_map[sl.agent_type], np.float32)
    drawn = (np.abs(render() - color[:, None, None]).max(axis=-3) < 1).sum()
    assert drawn > 0.2 * (RES / FOV) ** 2 * sl.length * sl.width


def test_textured_prim_frame_draws_no_sign():
    from torchdrivesim_tpu_torch.benchmark import build_benchmark_scenario
    from torchdrivesim_tpu_torch.map import find_map_config
    sim = build_benchmark_scenario(map_name='carla_Town10HD', batch_size=1, agent_count=2,
                                   res=64, fov=FOV, n_layouts=1, device='cpu').sim
    assert {'stop_sign', 'yield_sign'} <= set(sim.traffic_controls)
    signs = _signs(find_map_config('carla_Town10HD'))
    xy = torch.tensor([[[s.x, s.y] for s in signs]])
    psi = torch.zeros((1, len(signs), 1))
    with_signs = sim.render(xy, psi)
    bare = sim.copy()
    bare.birdview_mesh_generator.initialize_traffic_controls_mesh(
        {'traffic_light': sim.traffic_controls['traffic_light']})
    assert bare.birdview_mesh_generator.static_controls_rgb is None
    assert sim.birdview_mesh_generator.static_controls_rgb is not None
    assert torch.equal(with_signs, bare.render(xy, psi))
    # the mesh path over the texture draws them
    colors = torch.rand((1, len(signs), 2, 3), generator=torch.Generator().manual_seed(0))
    assert not torch.equal(sim.render(xy, psi, custom_agent_colors=colors),
                           bare.render(xy, psi, custom_agent_colors=colors))
