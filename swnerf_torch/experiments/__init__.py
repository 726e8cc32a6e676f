"""Side experiments (port of ``swnerf_tpu/experiments/``): the 2-D
positional-encoding study and its sweep runner."""
