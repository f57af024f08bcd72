"""
The port's scenario from the benchmark's inputs (:mod:`gpubench.world`),
through its public constructors: the bicycle kinematics, the traffic
lights on their schedule, the map grids, the renderer at the
configuration's resolution and field of view over the map's road mesh.
"""
import numpy as np
import torch

from gpubench import world


def build(r, w, renderer=None, grids: bool = True):
    """A ``benchmark.BenchmarkScenario`` on ``r.device`` over the road mesh;
    ``renderer`` is a ``RendererConfig`` (the default one when None)."""
    import torchdrivesim_tpu_torch.kinematic as K
    from torchdrivesim_tpu_torch.benchmark import BenchmarkScenario
    from torchdrivesim_tpu_torch.map import find_map_config
    from torchdrivesim_tpu_torch.map_grids import map_grids_from_arrays
    from torchdrivesim_tpu_torch.simulator import Simulator, TorchDriveConfig
    from torchdrivesim_tpu_torch.traffic_controls import TrafficLightControl
    from torchdrivesim_tpu_torch.traffic_lights import BakedLightSchedule
    from torchdrivesim_tpu_torch.utils import Resolution
    cfg, dev = r.config, r.device
    b, a = w['agent_state'].shape[:2]
    kin = K.KinematicBicycle(dt=cfg['dt'], left_handed=w['left_handed'], device=dev)
    kin.set_params(lr=w['lr'])
    kin.set_state(w['agent_state'])
    lights = w['lights']
    n = len(lights['ids'])
    control = TrafficLightControl(np.broadcast_to(lights['pos'], (b, n, 5)).copy(),
                                  allowed_states=list(world.LIGHT_STATES), device=dev)
    control.corners = torch.as_tensor(
        np.broadcast_to(lights['corners'], (b, n, 4, 2)).copy(), device=dev)
    control.actor_ids = list(lights['ids'])
    control.state = torch.as_tensor(lights['state0'], dtype=torch.int32,
                                    device=dev)[None].expand(b, n).contiguous()
    t = lights['schedule']
    schedule = BakedLightSchedule.from_tables(
        t['durations_cum'], t['colors'], t['tail_end'], t['period'], t['offset'],
        t['light_fsm'], t['n_rows'], lights['ids'], device=dev)
    control.set_schedule(schedule, dt=cfg['dt'])
    map_grids = None
    if grids:
        g = w['grids']
        map_grids = map_grids_from_arrays(
            g['distance'].astype(np.float32), g['distance_origin'],
            float(g['distance_cell']), g['direction'], g['direction_origin'],
            float(g['direction_cell']), device=dev)
    tcfg = TorchDriveConfig(left_handed_coordinates=w['left_handed'])
    if renderer is not None:
        tcfg.renderer = renderer
    sim = Simulator(road_mesh=find_map_config(w['map']).road_mesh,
                    kinematic_model=kin, agent_size=w['agent_size'],
                    initial_present_mask=np.ones((b, a), dtype=bool), cfg=tcfg,
                    traffic_controls={'traffic_light': control}, map_grids=map_grids)
    sim.renderer.res = Resolution(cfg['res'], cfg['res'])
    sim.renderer.scale = 2.0 / cfg['fov']
    return BenchmarkScenario(sim=sim, schedule=schedule, res=cfg['res'], fov=cfg['fov'],
                             dt=cfg['dt'])
