"""Host-side components (port of ``swnerf_tpu/native/``).

The reference vendors one native piece, the torchsearchsorted CPU/CUDA
extension. The JAX package builds it as a ctypes C++ library; the port
computes the same function with ``torch.searchsorted`` on the CPU.
"""

from swnerf_torch.native.searchsorted import native_available, searchsorted

__all__ = ["searchsorted", "native_available"]
