"""Shared building blocks for MLP fields (port of
``swnerf_tpu/models/common.py``).

The JAX package keeps weights ``[fan_in, fan_out]`` in a pytree; the port
keeps ``nn.Linear`` modules, whose weights are ``[fan_out, fan_in]`` like the
reference's ``.tar`` checkpoints. ``Field`` becomes the :class:`Field`
interface below.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


class Field(nn.Module):
    """A neural field consumed by the render core:
    ``forward(pts [N, S, 3], viewdirs [N, 3] | None, times [N, 1] | None)
    -> raw [N, S, C]``. ``cfg`` is the model config the field was built
    from."""

    cfg = None

    def mlp_layout(self) -> Tuple[List[List[str]], List[str]]:
        """The field's layers by module name, in the JAX param tree's order:
        its stacks (each an ``init_mlp_stack`` list) and its lone heads.
        Tensor parallelism (``parallel/tensor.py``) cuts them by this."""
        raise NotImplementedError(f"{type(self).__name__} gives no layout of its layers")


def safe_init_enabled() -> bool:
    """``SWNERF_SAFE_INIT=1``: opt-in remedy for the dead-density seed
    pathology. With the reference's init the initial density is about the
    density head's bias, a per-seed coin flip; a negative draw leaves the
    network ReLU-dead with zero gradients. Off by default: it changes the
    init distribution."""
    return os.environ.get("SWNERF_SAFE_INIT", "0") == "1"


@torch.no_grad()
def density_bias_floor(head: nn.Linear, index: Optional[int] = None, floor: float = 0.1) -> None:
    """Fold the density head's bias in place to ``|b| + floor`` (only entry
    ``index`` for a multi-channel output layer), so the initial density is
    positive everywhere and gradients flow from step one."""
    if index is None:
        head.bias.copy_(head.bias.abs() + floor)
    else:
        head.bias[index] = head.bias[index].abs() + floor


def torch_linear_init(
    fan_in: int,
    fan_out: int,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
) -> Dict[str, torch.Tensor]:
    """torch ``nn.Linear``'s default distribution, drawn from ``generator``
    on its own device and placed on ``device``:
    ``W [out, in], b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))``."""
    k = 1.0 / math.sqrt(fan_in)
    gdev = generator.device if generator is not None else None
    w = torch.rand((fan_out, fan_in), generator=generator, device=gdev) * (2 * k) - k
    b = torch.rand((fan_out,), generator=generator, device=gdev) * (2 * k) - k
    return {"weight": w.to(device), "bias": b.to(device)}


def kaiming_linear_init(
    fan_in: int,
    fan_out: int,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
) -> Dict[str, torch.Tensor]:
    """The D-NeRF canonical network's init (reference model.py:270-272, the
    JAX package's ``kaiming_linear_init``): ``W ~ N(0, 2 / fan_in)``, the
    bias as torch's default, drawn from ``generator``."""
    k = 1.0 / math.sqrt(fan_in)
    gdev = generator.device if generator is not None else None
    w = torch.randn((fan_out, fan_in), generator=generator, device=gdev) * math.sqrt(2.0 / fan_in)
    b = torch.rand((fan_out,), generator=generator, device=gdev) * (2 * k) - k
    return {"weight": w.to(device), "bias": b.to(device)}


def init_mlp_stack(
    dims: Sequence[Tuple[int, int]],
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
    init=torch_linear_init,
) -> List[nn.Linear]:
    """Linear layers with explicit ``(fan_in, fan_out)`` pairs (skip
    connections make the sizes non-chained), initialised by ``init``
    (:func:`torch_linear_init` or :func:`kaiming_linear_init`)."""
    layers = []
    for fi, fo in dims:
        # skip_init: the weights come from ``generator``, not the global RNG.
        lin = torch.nn.utils.skip_init(nn.Linear, fi, fo, device=device)
        p = init(fi, fo, generator, device)
        with torch.no_grad():
            lin.weight.copy_(p["weight"])
            lin.bias.copy_(p["bias"])
        layers.append(lin)
    return layers


class _RoundBF16(torch.autograd.Function):
    """Round to bf16 and back in the forward; pass the cotangent through."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], half: bool = False) -> torch.Tensor:
    """``x @ weight^T (+ bias)`` in fp32; ``half`` as :func:`dense`."""
    if half:
        return torch.nn.functional.linear(_RoundBF16.apply(x), _RoundBF16.apply(weight), bias)
    return torch.nn.functional.linear(x, weight, bias)


def dense(layer: nn.Module, x: torch.Tensor, half: bool = False) -> torch.Tensor:
    """``x @ W^T + b`` in fp32. ``half`` (a field config's
    ``half_precision``, D-NeRF's ``--do_half_precision``): ``x`` and ``W``
    rounded to bf16 first, the product and the bias in fp32, the port of
    the JAX package's ``dense(..., precision=Precision.DEFAULT)`` (one bf16
    pass with an fp32 sum on a TPU); the cotangents stay fp32. A layer cut
    into shards by tensor parallelism (``parallel/tensor.py``'s column and
    row layers) is called with ``half`` and runs the same product on its
    shard, with its collectives around it."""
    if not isinstance(layer, nn.Linear):
        return layer(x, half)
    return linear(x, layer.weight, layer.bias, half)
