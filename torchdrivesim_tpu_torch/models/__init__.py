"""Policy networks that consume bird's-eye-view images."""
from torchdrivesim_tpu_torch.models.policy import ActorCritic, BirdviewCNNPolicy

__all__ = ['ActorCritic', 'BirdviewCNNPolicy']
