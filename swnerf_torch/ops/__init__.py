"""Ray, embedding, sampling and compositing math (port of ``swnerf_tpu.ops``)."""
