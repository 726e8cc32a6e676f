"""The JAX package's kernel switches, read with its defaults.

- ``SWNERF_FUSED`` (default ``"1"``): ``"0"`` takes every kernel route
  away: plain fp32 fields, eager steps, no eval pass.
- ``SWNERF_FUSED_DTYPE`` (default ``"bf16"``): any other value does the
  same by default; fp32 kernels are explicit only, as
  ``models/vanilla.py:167-169`` of the JAX package has it, and explicit
  routes then run fp32 operands.
- ``SWNERF_FUSED_EVAL`` (default ``"1"``): ``"0"`` builds no eval pass, so
  ``render_image`` applies the fields.
- ``SWNERF_FUSED_STEP`` (default ``"1"``): ``"0"`` takes the eager
  autograd step.
- ``SWNERF_FUSED_INPUT_GRADS`` (unset): ``"1"`` keeps the embeddings
  attached on the kernel route, so their cotangents are formed.
- ``SWNERF_FUSED_RAW`` (unset): ``"1"`` runs the vanilla field's kernel
  route on B8 (the encode inside the kernel) in place of B7.
- ``SWNERF_FUSED_MULTIRES`` (default ``"0"``): ``"1"`` runs MultiRes phase 2
  fused (B6, B3's pts mode, B9) on every level that supports it, a comma
  list (``"1,0,0,0"``) chooses per level (run_multires.py:276-290 there).
- ``SWNERF_PDF_MERGE`` (default ``"0"``): ``"1"`` runs the importance
  resample and its sorted union as B10 (``ops/sampling.py:190-195`` there),
  with sorted uniforms.

:func:`kernel_route` is the JAX package's ``use_fused`` with the card in
place of the TPU. A field built with ``fused=None`` resolves it once, at
construction. The steps and eval passes follow the same switches on the CPU
too, where the kernels' plain twins stand in for them (the counterpart of the
JAX package's ``SWNERF_FUSED_STEP=force-interpret``, which its CPU tests
use): :func:`kernel_step` and :func:`eval_pass_route`. Each choice is a
check of the device and the environment, never a ``try`` around a build or
a launch. B2 (``sample_pdf``) is not among these: the JAX package gives its
Pallas sample_pdf a switch of its own (``SWNERF_PALLAS_SAMPLE_PDF``), and
the port launches B2 on every CUDA tensor.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

Device = Union[str, torch.device]


def _env(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def switches_on() -> bool:
    """``SWNERF_FUSED`` is not ``"0"`` and ``SWNERF_FUSED_DTYPE`` is
    ``"bf16"`` (both defaults)."""
    return _env("SWNERF_FUSED", "1") != "0" and _env("SWNERF_FUSED_DTYPE", "bf16") == "bf16"


def kernel_route(device: Device) -> bool:
    """The fields' default route: the kernels on a card, with the switches
    on (the JAX package's ``use_fused``)."""
    return torch.device(device).type == "cuda" and switches_on()


def _twins_or_kernels(device: Device) -> bool:
    return torch.device(device).type in ("cuda", "cpu") and switches_on()


def kernel_step(device: Device) -> bool:
    """A trainer takes its kernel step (where the configuration is
    supported): the switches on and ``SWNERF_FUSED_STEP`` not ``"0"``."""
    return _twins_or_kernels(device) and _env("SWNERF_FUSED_STEP", "1") != "0"


def eval_pass_route(device: Device) -> bool:
    """A trainer builds its eval pass (where the configuration is
    supported): the switches on and ``SWNERF_FUSED_EVAL`` not ``"0"``."""
    return _twins_or_kernels(device) and _env("SWNERF_FUSED_EVAL", "1") != "0"


def input_grads() -> bool:
    """``SWNERF_FUSED_INPUT_GRADS=1``: the kernel route keeps the embeddings
    attached."""
    return _env("SWNERF_FUSED_INPUT_GRADS") == "1"


def raw_route() -> bool:
    """``SWNERF_FUSED_RAW=1``: the vanilla field runs B8."""
    return _env("SWNERF_FUSED_RAW") == "1"


def fused_multires(device: Device, can) -> list:
    """Per level, whether MultiRes phase 2 runs fused: ``can[l]`` (the
    level supports it) and ``SWNERF_FUSED_MULTIRES`` chooses it (``"1"``:
    every level, ``"1,0,0,0"``: per level, else none), with the switches on
    (the twins on the CPU, as :func:`kernel_step`)."""
    mode = _env("SWNERF_FUSED_MULTIRES", "0")
    if not _twins_or_kernels(device):
        return [False] * len(can)
    if mode == "1":
        return list(can)
    if "," in mode:
        flags = [x.strip() == "1" for x in mode.split(",")]
        return [c and l < len(flags) and flags[l] for l, c in enumerate(can)]
    return [False] * len(can)


def pdf_merge() -> bool:
    """``SWNERF_PDF_MERGE=1``: the importance resample and its sorted union
    run as B10 (its twin on the CPU)."""
    return _env("SWNERF_PDF_MERGE", "0") == "1"


def operand_dtype(device: Device, compute_dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The kernel route's operand type: ``compute_dtype`` where given (the
    parity mode), else bf16 on a card under ``SWNERF_FUSED_DTYPE=bf16`` and
    fp32 otherwise (the CPU's twins run fp32)."""
    if compute_dtype is not None:
        return compute_dtype
    bf16 = torch.device(device).type == "cuda" and _env("SWNERF_FUSED_DTYPE", "bf16") == "bf16"
    return torch.bfloat16 if bf16 else torch.float32
