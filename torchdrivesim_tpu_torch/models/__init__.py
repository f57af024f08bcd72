"""Policy networks that consume bird's-eye-view images."""
from torchdrivesim_tpu_torch.models.policy import BirdviewCNNPolicy

__all__ = ['BirdviewCNNPolicy']
