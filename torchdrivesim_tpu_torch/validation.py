"""
Runtime validation (counterpart of ``torchdrivesim_tpu/validation.py``):
shape invariants of a :class:`~torchdrivesim_tpu_torch.simulator.SimulatorState`
and finiteness checks that raise. Each value check reads the device (a
host sync), so call them where a run may stop, not inside a timed loop.
"""
from typing import Any, Callable

import torch


class CheckError(ValueError):
    """A runtime check of the simulator's values failed."""


def validate_state_shapes(state, agent_count: int, batch_size: int) -> None:
    """Raise ``ValueError`` unless the state holds ``batch_size``
    environments of ``agent_count`` agents with 4-wide states and masks of
    their shapes, and NPCs with masks of theirs."""
    agent, npc = state.agent_state, state.npc_state
    checks = (
        (agent.shape[0] == batch_size, f'batch {agent.shape[0]} != {batch_size}'),
        (agent.shape[-2] == agent_count, f'agents {agent.shape[-2]} != {agent_count}'),
        (agent.shape[-1] == 4, f'state width {agent.shape[-1]} != 4'),
        (state.present_mask.shape == agent.shape[:-1],
         f'present mask {tuple(state.present_mask.shape)}'),
        (npc.shape[0] == batch_size, f'NPC batch {npc.shape[0]} != {batch_size}'),
        (state.npc_present_mask.shape == npc.shape[:-1],
         f'NPC present mask {tuple(state.npc_present_mask.shape)}'),
    )
    for ok, message in checks:
        if not ok:
            raise ValueError(f'simulator state: {message}')


def check_finite_state(state) -> None:
    """Raise :class:`CheckError` if an agent or NPC state is not finite."""
    if not bool(torch.isfinite(state.agent_state).all()):
        raise CheckError('non-finite agent state')
    if not bool(torch.isfinite(state.npc_state).all()):
        raise CheckError('non-finite NPC state')


def _floating_leaves(tree):
    """The floating-point tensors of a nest of dataclasses, dicts, lists
    and tuples."""
    if torch.is_tensor(tree):
        if tree.is_floating_point():
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _floating_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _floating_leaves(v)
    elif hasattr(tree, '__dataclass_fields__'):
        for name in tree.__dataclass_fields__:
            yield from _floating_leaves(getattr(tree, name))


def checked(fn: Callable) -> Callable:
    """
    ``fn`` with its checks surfaced: the checks it runs itself (such as
    :func:`check_finite_state`) raise as they fail, and a NaN in any
    floating-point tensor of its result raises :class:`CheckError`.

    Example:
        step = checked(lambda s, a: sim.functional_step(s, a))
        state = step(state, action)  # raises on NaN with a clear message
    """
    def wrapper(*args, **kwargs) -> Any:
        out = fn(*args, **kwargs)
        for leaf in _floating_leaves(out):
            if bool(torch.isnan(leaf).any()):
                raise CheckError(f'NaN in the result of {getattr(fn, "__name__", fn)}')
        return out
    return wrapper
