"""swnerf_torch: the PyTorch/CUDA port of ``swnerf_tpu`` for NVIDIA Hopper.

The JAX package ``swnerf_tpu`` is the reference; this package mirrors its
module layout so each counterpart is found under the same path. It imports
``torch`` and never ``jax`` or ``swnerf_tpu``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"`` (see :mod:`swnerf_torch.device`).
"""

from swnerf_torch.device import resolve_device

__all__ = ["resolve_device"]
