"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

| kernel | wrapper | source | replaces (TPU kernel) |
|---|---|---|---|
| B2 | ``sample_pdf.sample_pdf`` | ``csrc/sample_pdf.cu`` | ``swnerf_tpu/ops/pallas/sample_pdf.py::_kernel`` |
| B3 | ``render_pass.render_pass`` | ``csrc/render_pass.cu`` | ``swnerf_tpu/ops/pallas/render_fused.py::_render_loss_kernel`` (forward only) |
| B1 | ``render_loss.render_loss`` | ``csrc/render_loss.cu`` | ``swnerf_tpu/ops/pallas/render_fused.py::_render_loss_kernel`` (train mode) |
| B4 | ``render_pass.render_pass`` and ``render_loss.render_loss`` with ``arch="tnerf"`` packed weights | ``csrc/render_pass.cu``, ``csrc/render_loss.cu`` | ``_render_loss_kernel`` with ``arch="tnerf"`` (forward only and train mode) |
| B3 ``pts`` | ``render_pass.render_pass(pts=...)`` | ``csrc/render_pass.cu`` | ``_render_loss_kernel`` with ``pts=`` (forward only) |
| B5 | ``render_loss.render_loss_pts`` | ``csrc/render_loss.cu`` | ``_render_loss_kernel`` with ``pts=``, ``need_input_grads=True`` |
| B6 | ``time_net.time_net``, ``time_net.time_net_autograd`` | ``csrc/time_net.cu`` | ``swnerf_tpu/ops/pallas/raymarch.py::_fwd_kernel_plain`` / ``_bwd_kernel_plain`` |
| B7 | ``trunk.trunk``, ``trunk.trunk_autograd`` | ``csrc/trunk.cu`` | ``swnerf_tpu/ops/pallas/raymarch.py::_fwd_kernel`` / ``_bwd_kernel`` (``fused_trunk``) |
| B7' | the same on ``trunk.pack_tnerf_trunk_params`` weights | ``csrc/trunk.cu`` (``TrunkElu``) | the same bodies with ``act="elu"``, ``rgb_relu=True`` (``fused_tnerf``) |
| B8 | ``trunk.field_raw``, ``trunk.field_raw_autograd`` | ``csrc/trunk.cu`` (``TrunkRaw``) | ``raymarch.py::_fwd_kernel_raw`` / ``_bwd_kernel_raw`` (``fused_field_raw``) |

B4 is B3's and B1's body instantiated for the T-NeRF family (the ``TNerf``
traits of ``csrc/mlp_common.cuh``); its launches count as
``render_pass[tnerf,S=..]`` and ``render_loss[tnerf,S=..]``. B3's pts mode
and B5 count as ``render_pass[pts,S=..]`` and ``render_loss[pts,S=..]``,
B6 as ``time_net`` and ``time_net[bwd]``, B7 as ``trunk`` and
``trunk[bwd]``, B7' as ``trunk[tnerf]`` and ``trunk[tnerf,bwd]``, B8 as
``trunk[raw]`` and ``trunk[raw,bwd]``.

A wrapper given CPU tensors runs the plain twin; given CUDA tensors it
launches its kernel or raises. ``launches`` counts kernel launches by
kernel name; only a wrapper's launch site adds to it.
"""

from __future__ import annotations

import collections

launches: "collections.Counter[str]" = collections.Counter()
