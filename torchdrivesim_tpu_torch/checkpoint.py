"""
Checkpoint and resume of simulation and training state (counterpart of
``torchdrivesim_tpu/checkpoint.py``): a nest of dataclasses, dicts, lists
and tuples of tensors (``{'state': sim.state, 'params': ...}``) saved with
``torch.save`` as a flat state dict of its tensors, keyed by their paths,
and loaded with ``weights_only=True``. Zero-size tensors are not saved;
restoring into a target passes the target's through.
"""
import dataclasses
import os
from typing import Any, Dict, Optional

import torch


def _is_empty(x) -> bool:
    return torch.is_tensor(x) and x.numel() == 0


def _children(tree):
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def state_dict(tree: Any, prefix: str = '') -> Dict[str, torch.Tensor]:
    """The nonempty tensors of ``tree`` by path ('state/agent_state'), on
    the CPU."""
    out = {}
    children = _children(tree)
    if children is None:
        if torch.is_tensor(tree) and not _is_empty(tree):
            out[prefix] = tree.detach().cpu()
        return out
    for key, child in children:
        out.update(state_dict(child, f'{prefix}/{key}' if prefix else key))
    return out


def _rebuild(target: Any, saved: Dict[str, torch.Tensor], prefix: str = '') -> Any:
    """``target`` with each nonempty tensor replaced by the saved one of its
    path, on the target tensor's device."""
    children = _children(target)
    if children is None:
        if not torch.is_tensor(target) or _is_empty(target):
            return target
        if prefix not in saved:
            raise KeyError(f'checkpoint has no tensor {prefix!r}')
        value = saved[prefix]
        if value.shape != target.shape or value.dtype != target.dtype:
            raise ValueError(f'{prefix}: checkpoint holds {value.dtype} '
                             f'{tuple(value.shape)}, target {target.dtype} '
                             f'{tuple(target.shape)}')
        return value.to(target.device)
    new = {key: _rebuild(child, saved, f'{prefix}/{key}' if prefix else key)
           for key, child in children}
    if isinstance(target, dict):
        return type(target)((k, new[str(k)]) for k in target)
    if isinstance(target, (list, tuple)):
        return type(target)(new[str(i)] for i in range(len(target)))
    return dataclasses.replace(target, **new)


def save_checkpoint(path: str, tree: Any, force: bool = True) -> None:
    """
    Save the tensors of ``tree`` to the file ``path``; with ``force=False``
    an existing file raises ``FileExistsError``.
    """
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    torch.save(state_dict(tree), path)


def restore_checkpoint(path: str, target: Optional[Any] = None, device='cuda') -> Any:
    """
    Load the checkpoint at ``path``: into the structure of ``target`` (each
    tensor on the target tensor's device, shapes and dtypes checked,
    zero-size tensors the target's own), or without a target as the flat
    state dict on ``device``.
    """
    saved = torch.load(os.path.abspath(path), map_location='cpu', weights_only=True)
    if target is None:
        return {k: v.to(device) for k, v in saved.items()}
    return _rebuild(target, saved)


def save_simulator(path: str, simulator) -> None:
    """Save a simulator's dynamic state (its parameters are code and
    assets)."""
    save_checkpoint(path, {'state': simulator.state})


def restore_simulator(path: str, simulator) -> None:
    """Restore a saved state into ``simulator``, on its own device."""
    simulator.state = restore_checkpoint(path, {'state': simulator.state})['state']
    simulator._sync_legacy_state()
