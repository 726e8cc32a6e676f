"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

| kernel | wrapper | source | replaces (TPU kernel) |
|---|---|---|---|
| B2 | ``sample_pdf.sample_pdf`` | ``csrc/sample_pdf.cu`` | ``swnerf_tpu/ops/pallas/sample_pdf.py::_kernel`` |
| B3 | ``render_pass.render_pass`` | ``csrc/render_pass.cu`` | ``swnerf_tpu/ops/pallas/render_fused.py::_render_loss_kernel`` (forward only) |
| B1 | ``render_loss.render_loss`` | ``csrc/render_loss.cu`` | ``swnerf_tpu/ops/pallas/render_fused.py::_render_loss_kernel`` (train mode) |

A wrapper given CPU tensors runs the plain twin; given CUDA tensors it
launches its kernel or raises. ``launches`` counts kernel launches by
kernel name; only a wrapper's launch site adds to it.
"""

from __future__ import annotations

import collections

launches: "collections.Counter[str]" = collections.Counter()
