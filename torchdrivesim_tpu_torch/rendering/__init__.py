"""Bird's-eye-view rendering of the port."""
from torchdrivesim_tpu_torch.rendering.base import (
    Cameras, RendererConfig, get_default_color_map, get_default_rendering_levels,
)
from torchdrivesim_tpu_torch.rendering.renderer import Renderer

__all__ = ['Cameras', 'Renderer', 'RendererConfig', 'get_default_color_map',
           'get_default_rendering_levels']
