"""Dataset loaders (port of ``swnerf_tpu.data``; Blender only in this slice)."""
