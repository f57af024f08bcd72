"""
NPCs driven by the Inverted AI API (counterpart of
``torchdrivesim_tpu/behavior/iai.py``).

The API is a network service: INITIALIZE places agents, DRIVE predicts
their next states. Its calls block on the host, so
:meth:`IAINPCController.advance` is a host boundary: it reads the NPC and
ego states back from the device, calls DRIVE and writes the predictions
back, eagerly (it cannot be captured in a CUDA graph). The
``invertedai`` client is imported at first use; without it this module
still imports, and every entry point that needs the client raises.
"""
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from torchdrivesim_tpu_torch.behavior.common import InitializationFailedError
from torchdrivesim_tpu_torch.simulator import NPCController, SpawnController
from torchdrivesim_tpu_torch.traffic_lights import (
    TrafficLightController, current_light_state_tensor_from_controller,
)

#: the ``invertedai`` client module, imported by :func:`_require_client`
invertedai = None


def _require_client():
    """The ``invertedai`` module, imported at first use."""
    global invertedai
    if invertedai is None:
        try:
            import invertedai as client
        except ImportError as e:
            raise ImportError("The invertedai package is required for IAI-driven "
                              "NPCs; install it and set IAI_API_KEY.") from e
        invertedai = client
    return invertedai


def unpack_attributes(attributes) -> torch.Tensor:
    """API ``AgentAttributes`` -> (3,) length, width, rear axis offset."""
    return torch.tensor([attributes.length, attributes.width,
                         attributes.rear_axis_offset], dtype=torch.float32)


def agent_attributes_to_basic_agent_properties(agent_attributes) -> dict:
    """(3,) attributes -> the API's properties dict."""
    return {'length': agent_attributes[0], 'width': agent_attributes[1],
            'rear_axis_offset': agent_attributes[2]}


def agent_properties_to_agent_attributes(agent_properties: dict) -> torch.Tensor:
    """The API's properties dict -> (3,) float32 attributes."""
    return torch.tensor([agent_properties['length'], agent_properties['width'],
                         agent_properties['rear_axis_offset']], dtype=torch.float32)


def iai_initialize(location: str, agent_count: int,
                   center: Tuple[float, float] = (0, 0),
                   traffic_light_state_history: Optional[list] = None, device='cuda'
                   ) -> Tuple[torch.Tensor, torch.Tensor, list]:
    """
    The INITIALIZE endpoint: (agent attributes (1, A, 3), states (1, A, 4),
    recurrent states), the tensors float32 on ``device``.

    Raises:
        InitializationFailedError when the API refuses.
    """
    client = _require_client()
    try:
        response = client.api.initialize(
            location=location, agent_count=agent_count, location_of_interest=center,
            traffic_light_state_history=traffic_light_state_history)
    except client.error.InvertedAIError as e:
        raise InitializationFailedError(str(e)) from e
    attrs = [[a.length, a.width, a.rear_axis_offset] for a in response.agent_attributes]
    states = [[s.center.x, s.center.y, s.orientation, s.speed]
              for s in response.agent_states]
    as_t = lambda x: torch.tensor(x, dtype=torch.float32, device=device)[None]
    return as_t(attrs), as_t(states), response.recurrent_states


def iai_drive(location: str, agent_states, agent_attributes, recurrent_states,
              traffic_lights_states=None, large: bool = False):
    """The DRIVE endpoint (its large-scene variant with ``large``)."""
    client = _require_client()
    api = client.large_drive if large else client.api.drive
    return api(location=location, agent_states=agent_states,
               agent_attributes=agent_attributes, recurrent_states=recurrent_states,
               traffic_lights_states=traffic_lights_states)


class IAINPCController(NPCController):
    """
    NPCs driven by DRIVE, one batch element only. Each :meth:`advance`
    ticks the host traffic-light controller (when given, also writing its
    state into the simulator's 'traffic_light' control), sends the present
    NPCs and the simulator's agents, and takes the predicted NPC states.

    Args:
        location: IAI location name.
        recurrent_states: from :func:`iai_initialize`.
        traffic_light_controller: host FSM controller ticked each step.
        traffic_light_ids: its lights, in the control's order.
    """
    LARGE_AGENT_THRESHOLD = 100

    def __init__(self, npc_size, npc_state, location: str, recurrent_states=None,
                 npc_present_mask=None, npc_types=None,
                 agent_type_names: Optional[List[str]] = None,
                 spawn_controller: Optional[SpawnController] = None,
                 traffic_light_controller: Optional[TrafficLightController] = None,
                 traffic_light_ids: Optional[List[int]] = None, dt: float = 0.1):
        _require_client()
        super().__init__(npc_size, npc_state, npc_present_mask, npc_types,
                         agent_type_names, spawn_controller)
        self.location = location
        self.recurrent_states = recurrent_states
        self.traffic_light_controller = traffic_light_controller
        self.traffic_light_ids = traffic_light_ids or []
        self.dt = dt

    def copy(self) -> "IAINPCController":
        return self.__class__(
            self.npc_size, self.initial_npc_state, self.location,
            recurrent_states=self.recurrent_states,
            npc_present_mask=self.initial_npc_present_mask, npc_types=self.npc_types,
            agent_type_names=self.agent_type_names,
            spawn_controller=self.spawn_controller.copy(),
            traffic_light_controller=self.traffic_light_controller,
            traffic_light_ids=list(self.traffic_light_ids), dt=self.dt)

    def advance(self, npc_state, npc_present_mask, time, simulator=None):
        client = _require_client()
        states = npc_state.detach().cpu().numpy()
        present = npc_present_mask.cpu().numpy()
        sizes = self.npc_size.cpu().numpy()
        assert states.shape[0] == 1, "IAI controller supports batch size 1"

        lights = None
        if self.traffic_light_controller is not None:
            self.traffic_light_controller.tick(self.dt)
            lights = self.traffic_light_controller.current_state_with_name
            if simulator is not None and simulator.traffic_controls and \
                    'traffic_light' in simulator.traffic_controls:
                tensor = current_light_state_tensor_from_controller(
                    self.traffic_light_controller, self.traffic_light_ids,
                    device=npc_state.device)
                simulator.state = dataclasses.replace(
                    simulator.state, traffic_control_state={
                        **simulator.state.traffic_control_state,
                        'traffic_light': tensor[None]})

        def agent(x, y, psi, speed, length, width):
            return (client.common.AgentState(
                center=client.common.Point(x=float(x), y=float(y)),
                orientation=float(psi), speed=float(speed)),
                client.common.AgentAttributes(length=float(length), width=float(width),
                                              rear_axis_offset=float(length) * 0.4))

        present_idx = np.nonzero(present[0])[0]
        pairs = [agent(*states[0, i], *sizes[0, i]) for i in present_idx]
        # condition on the simulator's agents too
        if simulator is not None:
            ego = simulator.get_state().detach().cpu().numpy()
            ego_size = simulator.get_agent_size().cpu().numpy()
            pairs += [agent(*ego[0, a], *ego_size[0, a]) for a in range(ego.shape[1])]
        agent_states = [s for s, _ in pairs]
        agent_attributes = [a for _, a in pairs]
        response = iai_drive(self.location, agent_states, agent_attributes,
                             self.recurrent_states, traffic_lights_states=lights,
                             large=len(agent_states) >= self.LARGE_AGENT_THRESHOLD)
        self.recurrent_states = response.recurrent_states
        new_states = states.copy()
        for slot, pred in zip(present_idx, response.agent_states):
            new_states[0, slot] = [pred.center.x, pred.center.y, pred.orientation,
                                   pred.speed]
        state = torch.as_tensor(new_states, device=npc_state.device)
        return self.spawn_controller.apply(state, npc_present_mask, time)
