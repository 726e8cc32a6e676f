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
| B3 ``pts``, wide | ``render_pass.render_pass(pts=...)`` on a wide pack | ``csrc/render_pass.cu`` (``VanillaWide``) | ``_render_loss_kernel`` with ``pts=``, inputs up to 128 columns (the MultiRes eval pass) |
| B9 | ``render_loss.render_loss_ext``, ``render_loss.render_outputs_autograd`` | ``csrc/render_loss.cu`` (``EXT``) | ``_render_loss_kernel`` with ``ext_ct=True`` (``make_render_outputs``) |
| B10 | ``sample_pdf.sample_pdf_merge`` | ``csrc/sample_pdf.cu`` | ``swnerf_tpu/ops/pallas/sample_pdf.py::_merge_kernel`` (``sample_pdf_merge_pallas``) |
| B11 | ``time_net.fused_time_net_pts`` | ``csrc/time_net.cu`` (``time_net_bwd_din_launch``) | ``raymarch.py::_fwd_kernel_plain_raw`` / ``_bwd_kernel_plain_raw`` (``fused_time_net_pts``) |

B4 is B3's and B1's body instantiated for the T-NeRF family (the ``TNerf``
traits of ``csrc/mlp_common.cuh``); its launches count as
``render_pass[tnerf,S=..]`` and ``render_loss[tnerf,S=..]``. B3's pts mode
and B5 count as ``render_pass[pts,S=..]`` and ``render_loss[pts,S=..]``,
B6 as ``time_net`` and ``time_net[bwd]``, B7 as ``trunk`` and
``trunk[bwd]``, B7' as ``trunk[tnerf]`` and ``trunk[tnerf,bwd]``, B8 as
``trunk[raw]`` and ``trunk[raw,bwd]``, B3's pts mode at the MultiRes widths
as ``render_pass[pts,wide,S=..]``, B9 as ``render_loss[ext,S=..]`` and
``render_loss[ext,wide,S=..]``, B10 as ``sample_pdf_merge``, B11's backward
as ``time_net[pts,bwd]`` (its forward is B6's ``time_net``).

In bf16, B3 (every mode), B4's forward and B6's forward run on the tensor
cores (``csrc/tc_chunk.cuh``, ``csrc/tc_render.cuh``); their wrappers hand
the launchers a scratch for the weight image, of the size the libraries give
(``render_pass_image_bytes``, ``time_net_image_bytes``). The reverse sweeps
of bf16 B1, B4, B6 and B7 (with B7's input cotangent) run their large
products on them too (``csrc/tc_gemm.cuh``). The rest, every fp32
instantiation, B9 and the training path's B3 launch
(``render_pass(..., ordered=True)``, which B9's recomputed forward equals)
are SIMT.

A wrapper given CPU tensors runs the plain twin; given CUDA tensors it
launches its kernel or raises. ``launches`` counts kernel launches by
kernel name; only a wrapper's launch site adds to it, and a CUDA graph's
replay adds what its capture counted (``pipelines/common.py::KStepRoute``).
:func:`traced_launches` counts what the device really ran, from a
``torch.profiler`` trace.
"""

from __future__ import annotations

import collections
import functools
import re

launches: "collections.Counter[str]" = collections.Counter()


@functools.lru_cache(maxsize=None)
def _kernel_names() -> frozenset:
    """The ``__global__`` functions of ``csrc``."""
    from swnerf_torch.ops.kernels.build import CSRC

    decl = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")
    return frozenset(m.group(1) for f in CSRC.glob("*.cu*") for m in decl.finditer(f.read_text()))


# The port's kernels live in csrc's anonymous namespace (and its ``tc``):
# their trace names, demangled or not, start there; torch's own kernels
# start in ``at::`` or elsewhere.
_TRACE_NAME = re.compile(r"^(?:void\s+)?\(anonymous namespace\)::(?:tc::)?(\w+)|^_ZN12_GLOBAL__N_1(?:2tc)?\d+(\w+?)(?:I|E)")


def traced_launches(averages) -> "collections.Counter[str]":
    """Launches of the port's own kernels in a ``torch.profiler`` trace
    (``prof.key_averages()``), by ``__global__`` name: what the device ran,
    uncaptured or in a graph's replays. One wrapper launch may run several
    (a reverse sweep's products and reductions)."""
    names, out = _kernel_names(), collections.Counter()
    for e in averages:
        m = _TRACE_NAME.match(e.key)
        name = m and (m.group(1) or m.group(2))
        if name in names:
            out[name] += e.count
    return out
