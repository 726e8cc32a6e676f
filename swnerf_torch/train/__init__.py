"""Train state, Adam, the eager and kernel train steps, and checkpoints
(port of ``swnerf_tpu.train``)."""
