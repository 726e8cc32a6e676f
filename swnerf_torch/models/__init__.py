"""Neural fields (port of ``swnerf_tpu.models``)."""

from swnerf_torch.models.dnerf import DirectTemporalNeRF, DNeRFConfig, NeRFOriginal, make_dnerf_model
from swnerf_torch.models.tnerf import TNeRF, TNeRFConfig
from swnerf_torch.models.vanilla import VanillaNeRF, VanillaNeRFConfig

__all__ = [
    "DNeRFConfig", "DirectTemporalNeRF", "NeRFOriginal", "TNeRF", "TNeRFConfig", "VanillaNeRF", "VanillaNeRFConfig",
    "make_dnerf_model",
]
