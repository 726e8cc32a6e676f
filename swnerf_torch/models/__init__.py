"""Neural fields (port of ``swnerf_tpu.models``)."""

from swnerf_torch.models.tnerf import TNeRF, TNeRFConfig
from swnerf_torch.models.vanilla import VanillaNeRF, VanillaNeRFConfig

__all__ = ["TNeRF", "TNeRFConfig", "VanillaNeRF", "VanillaNeRFConfig"]
