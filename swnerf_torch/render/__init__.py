"""The volumetric render core (port of ``swnerf_tpu.render``)."""

from swnerf_torch.render.core import Rays, RenderConfig, make_rays_from_camera, render_image, render_rays

__all__ = ["Rays", "RenderConfig", "make_rays_from_camera", "render_image", "render_rays"]
