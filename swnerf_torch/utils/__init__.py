"""Config, metrics, images (port of ``swnerf_tpu.utils``)."""
