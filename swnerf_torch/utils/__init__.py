"""Config, metrics, images, experiment logging (port of ``swnerf_tpu.utils``)."""
