"""Checkpoints (port of ``swnerf_tpu.train``; training itself is a later slice)."""
