"""
Bird's-eye-view rendering of the port, and the renderer factory: the
configuration's class (or its ``backend`` string) selects the renderer.
The reference's OpenCV, pytorch3d and nvdiffrast backends keep their
configuration and renderer class names, and render through the port's
:class:`Renderer`.
"""
import enum
from typing import Union

from torchdrivesim_tpu_torch.rendering.base import (
    BirdviewRenderer, BirdviewRendererConfig, Cameras, CV2RendererConfig, DummyRenderer,
    DummyRendererConfig, JaxRendererConfig, NvdiffrastRendererConfig,
    Pytorch3DRendererConfig, RendererConfig, get_default_color_map,
    get_default_rendering_levels,
)
from torchdrivesim_tpu_torch.rendering.renderer import Renderer

#: the reference's name of :class:`Renderer`
JaxRenderer = Renderer

_BACKENDS = {
    'default': (RendererConfig, Renderer),
    'jax': (RendererConfig, Renderer),
    'dummy': (DummyRendererConfig, DummyRenderer),
    'cv2': (RendererConfig, Renderer),
    'pytorch3d': (RendererConfig, Renderer),
    'nvdiffrast': (RendererConfig, Renderer),
}


def lift_renderer_config(cfg: Union[BirdviewRendererConfig, dict]
                         ) -> BirdviewRendererConfig:
    """
    The configuration :func:`renderer_from_config` builds from: the
    backend's own configuration, ``cfg`` itself when it is one, else a new
    one. A dict's ``backend`` key picks the backend (the other keys that
    its configuration has become its fields); an unknown backend takes the
    default; a configuration that is not the backend's own (a base or shim
    configuration) is lifted into it, keeping the base fields; a
    ``Pytorch3DRendererConfig`` whose ``differentiable_rendering`` is
    'soft' or 'sigmoid' gives a differentiable one.
    """
    if isinstance(cfg, dict):
        cfg_cls, _ = _BACKENDS.get(cfg.get('backend', 'default'), _BACKENDS['default'])
        cfg = cfg_cls(**{k: v for k, v in cfg.items()
                         if k in cfg_cls.__dataclass_fields__})
    cfg_cls, _ = _BACKENDS.get(getattr(cfg, 'backend', 'default'), _BACKENDS['default'])
    if isinstance(cfg, cfg_cls):
        return cfg
    lifted = cfg_cls(**{k: getattr(cfg, k) for k in BirdviewRendererConfig.__dataclass_fields__
                        if k != 'backend'})
    if isinstance(cfg, Pytorch3DRendererConfig) and isinstance(lifted, RendererConfig):
        blend = getattr(cfg.differentiable_rendering, 'value', cfg.differentiable_rendering)
        lifted.differentiable = str(blend) in ('soft', 'sigmoid')
    return lifted


def renderer_from_config(cfg: Union[BirdviewRendererConfig, dict], device=None,
                         **kwargs) -> BirdviewRenderer:
    """
    Build a renderer from a configuration object or a dict with a
    ``backend`` key, lifted by :func:`lift_renderer_config`.

    Args:
        device: where the renderer makes its frames; ``cfg.device`` when
            None, else the card.
        kwargs: ``res``, ``fov``, ``color_map``, ``rendering_levels``.
    """
    cfg = lift_renderer_config(cfg)
    _, renderer_cls = _BACKENDS.get(cfg.backend, _BACKENDS['default'])
    if device is None:
        device = getattr(cfg, 'device', None) or 'cuda'
    return renderer_cls(cfg, device, **kwargs)


class RenderingBlend(enum.Enum):
    """Blend names of the reference's pytorch3d backend: 'hard' is hard
    coverage, 'soft' and 'sigmoid' the differentiable soft raster."""
    hard = 'hard'
    soft = 'soft'
    sigmoid = 'sigmoid'


class Pytorch3DNotFound(ImportError):
    """Kept for the reference's except clauses; never raised (the port's
    renderer is always there)."""


class NvdiffrastNotFound(ImportError):
    """Kept for the reference's except clauses; never raised (the port's
    renderer is always there)."""


class CV2Renderer(Renderer):
    """The reference's OpenCV renderer class name; renders as
    :class:`Renderer`."""


class Pytorch3DRenderer(Renderer):
    """The reference's pytorch3d renderer class name; renders as
    :class:`Renderer` (differentiable with ``RendererConfig(
    differentiable=True)``, or a ``Pytorch3DRendererConfig`` through
    :func:`renderer_from_config`)."""


class NvdiffrastRenderer(Renderer):
    """The reference's nvdiffrast renderer class name; renders as
    :class:`Renderer`."""


__all__ = [
    'BirdviewRenderer', 'BirdviewRendererConfig', 'Cameras', 'CV2Renderer',
    'CV2RendererConfig', 'DummyRenderer', 'DummyRendererConfig', 'JaxRenderer',
    'JaxRendererConfig', 'NvdiffrastNotFound', 'NvdiffrastRenderer',
    'NvdiffrastRendererConfig', 'Pytorch3DNotFound', 'Pytorch3DRenderer',
    'Pytorch3DRendererConfig', 'Renderer', 'RendererConfig', 'RenderingBlend',
    'get_default_color_map', 'get_default_rendering_levels', 'lift_renderer_config',
    'renderer_from_config',
]
