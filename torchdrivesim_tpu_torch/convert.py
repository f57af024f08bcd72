"""
Build the port's benchmark scenario from a scenario's data given as numpy
arrays, such as the JAX package's scenario with ``np.asarray`` applied to
its leaves, so both packages step the same world; and carry flax
``BirdviewCNNPolicy`` and ``ActorCritic`` parameter trees across as the
port's ``state_dict`` (:func:`policy_state_dict_from_flax`,
:func:`actor_critic_state_dict_from_flax`).

The arrays (B environments, A agents, N traffic lights):

* state: ``agent_state`` (B, A, 4), ``present_mask`` (B, A),
  ``npc_state`` (B, Npc, 4), ``npc_present_mask`` (B, Npc),
  ``traffic_light_state`` (B, N), ``time`` and ``npc_time`` (scalars);
* kinematics and sizes: ``lr`` (B, A), ``agent_size`` (B, A, 2),
  ``npc_size`` (B, Npc, 2);
* the light control: ``light_pos`` (B, N, 5), ``light_corners``
  (B, N, 4, 2), ``light_allowed_states`` (list of names), ``light_ids``;
* the light schedule tables ``schedule_durations_cum``,
  ``schedule_colors``, ``schedule_tail_end``, ``schedule_period``,
  ``schedule_offset``, ``schedule_light_fsm``, ``schedule_n_rows``
  (see :class:`BakedLightSchedule`), absent when no schedule drives them;
* the map grids: ``distance`` (H, W, 1), ``distance_origin``,
  ``distance_cell``, ``direction`` (H', W', 1) int32, ``direction_origin``,
  ``direction_cell``;
* the texture: ``texture`` (H, W, 3) float in [0, 1], ``texture_origin``,
  ``texture_cell``;
* scalars: ``dt``, ``res``, ``fov``, ``left_handed``, and optionally
  ``background_downsample`` (the renderer's, 1 when absent);
* optionally ``model_assignments`` (B, A) int kinematic model ids: the
  agents are then stepped by a ``CompoundKinematicModel`` over the same
  parameters (as BASELINE config 3), else by the bicycle.
"""
from typing import Dict

import numpy as np
import torch

import torchdrivesim_tpu_torch.kinematic as K
from torchdrivesim_tpu_torch.benchmark import BenchmarkScenario
from torchdrivesim_tpu_torch.map_grids import map_grids_from_arrays
from torchdrivesim_tpu_torch.ops.grids import Grid2D
from torchdrivesim_tpu_torch.simulator import (
    NPCController, Simulator, TorchDriveConfig,
)
from torchdrivesim_tpu_torch.traffic_controls import TrafficLightControl
from torchdrivesim_tpu_torch.traffic_lights import BakedLightSchedule
from torchdrivesim_tpu_torch.utils import Resolution


def scenario_from_arrays(a: Dict, device='cuda') -> BenchmarkScenario:
    """The port's :class:`BenchmarkScenario` from the arrays listed in the
    module docstring, on ``device``."""
    dev = torch.device(device)
    # a copy: the source's arrays may be read-only views of its buffers
    t = lambda x, dtype=torch.float32: torch.as_tensor(np.array(x), dtype=dtype,
                                                       device=dev)
    b, n_agents = np.shape(a['present_mask'])
    left_handed = bool(a['left_handed'])
    res, fov, dt = int(a['res']), float(a['fov']), float(a['dt'])

    kin = K.KinematicBicycle(dt=dt, left_handed=left_handed, device=dev)
    kin.set_params(lr=a['lr'])
    if a.get('model_assignments') is not None:
        kin = K.CompoundKinematicModel(a['model_assignments'], params=kin.params,
                                       dt=dt, device=dev)
    kin.set_state(a['agent_state'])

    control = TrafficLightControl(a['light_pos'],
                                  allowed_states=list(a['light_allowed_states']),
                                  device=dev)
    control.corners = t(a['light_corners'])    # bit-identical to the source's
    control.state = t(a['traffic_light_state'], torch.int32)
    control.actor_ids = [int(i) for i in a['light_ids']]

    cfg = TorchDriveConfig(left_handed_coordinates=left_handed)
    cfg.renderer.background_downsample = int(a.get('background_downsample', 1))
    npc = NPCController(t(a['npc_size']), t(a['npc_state']),
                        t(a['npc_present_mask'], torch.bool))
    grids = map_grids_from_arrays(
        a['distance'], a['distance_origin'], a['distance_cell'],
        a.get('direction'), a.get('direction_origin'), a.get('direction_cell'),
        device=dev)
    sim = Simulator(road_mesh=None, kinematic_model=kin,
                    agent_size=a['agent_size'],
                    initial_present_mask=a['present_mask'], cfg=cfg,
                    traffic_controls={'traffic_light': control},
                    map_grids=grids, npc_controller=npc,
                    internal_time=int(a['time']))
    sim.state.npc_time = torch.tensor(int(a['npc_time']), dtype=torch.int32,
                                      device=dev)
    sim.renderer.res = Resolution(res, res)
    sim.renderer.scale = 2.0 / fov
    sim.renderer.background_texture = Grid2D(
        data=np.asarray(a['texture'], np.float32),
        origin=np.asarray(a['texture_origin'], np.float32),
        cell_size=float(a['texture_cell']))

    schedule = None
    if 'schedule_durations_cum' in a:
        schedule = BakedLightSchedule.from_tables(
            a['schedule_durations_cum'], a['schedule_colors'],
            a['schedule_tail_end'], a['schedule_period'], a['schedule_offset'],
            a['schedule_light_fsm'], a['schedule_n_rows'], a['light_ids'],
            device=dev)
        control.set_schedule(schedule, dt=dt)
    return BenchmarkScenario(sim=sim, schedule=schedule, res=res, fov=fov, dt=dt)


def _convs_from_flax(tree: Dict, t) -> Dict[str, torch.Tensor]:
    """``Conv_i`` kernels HWIO -> OIHW, as ``convs.i.weight`` / ``bias``."""
    out = {}
    n_conv = sum(1 for k in tree if k.startswith('Conv_'))
    for i in range(n_conv):
        conv = tree[f'Conv_{i}']
        out[f'convs.{i}.weight'] = t(np.transpose(np.asarray(conv['kernel']),
                                                  (3, 2, 0, 1)))
        out[f'convs.{i}.bias'] = t(conv['bias'])
    return out


def policy_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """
    The port's ``BirdviewCNNPolicy`` state dict from a flax parameter tree
    ``{'params': {'Conv_i': {'kernel': (3, 3, Cin, Cout), 'bias'},
    'Dense_0', 'Dense_1': {'kernel': (in, out), 'bias'}}}`` of numpy arrays
    (or anything ``np.asarray`` takes): convolution kernels HWIO -> OIHW,
    dense kernels transposed. The tensors are on the CPU; ``load_state_dict``
    copies them to the module's device.
    """
    tree = params.get('params', params)
    t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    out = _convs_from_flax(tree, t)
    for i in range(2):
        dense = tree[f'Dense_{i}']
        out[f'dense_{i}.weight'] = t(np.asarray(dense['kernel']).T)
        out[f'dense_{i}.bias'] = t(dense['bias'])
    return out


def actor_critic_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """
    The port's ``ActorCritic`` state dict from a flax ``ActorCritic``
    parameter tree ``{'params': {'Conv_i', 'Dense_0' (hidden), 'Dense_1'
    (mean head), 'Dense_2' (value head), 'log_std'}}`` of numpy arrays, laid
    out as :func:`policy_state_dict_from_flax` lays out its policy's.
    """
    tree = params.get('params', params)
    t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    out = _convs_from_flax(tree, t)
    for flax_name, name in (('Dense_0', 'dense_0'), ('Dense_1', 'mean_head'),
                            ('Dense_2', 'value_head')):
        out[f'{name}.weight'] = t(np.asarray(tree[flax_name]['kernel']).T)
        out[f'{name}.bias'] = t(tree[flax_name]['bias'])
    out['log_std'] = t(tree['log_std'])
    return out
