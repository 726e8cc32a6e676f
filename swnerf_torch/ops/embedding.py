"""Fourier-feature positional encoding (port of ``swnerf_tpu/ops/embedding.py``).

Feature order ``[x, sin(f0·x), cos(f0·x), sin(f1·x), cos(f1·x), ...]`` with
frequencies ``2^0 .. 2^(F-1)``; ``num_freqs == -1`` is the identity.
"""

from __future__ import annotations

import functools

import torch


def embedding_dim(num_freqs: int, input_dims: int = 3, include_input: bool = True) -> int:
    """Output feature size of :func:`positional_encoding`."""
    if num_freqs == -1:
        return input_dims
    out = 2 * num_freqs * input_dims
    if include_input:
        out += input_dims
    return out


@functools.lru_cache(maxsize=None)
def _octaves(num_freqs: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``2^0 .. 2^(F-1)``, exact, so x * f is exact in fp32. Made once per
    device and read from then on: a copy from the host at every call would
    synchronize, and a train step captured in a CUDA graph may not copy.
    Eager calls keep this cache rather than the traced path's factory ops:
    those add three launches a call, which the host-paced mesh sweep pays
    at every tile (its per-tile encode 34.5 ms a sweep with the cache,
    83.1 ms with the factory ops, H100, chip_smoke.py phase 29)."""
    return torch.tensor([2.0**i for i in range(num_freqs)], dtype=dtype, device=device)


def positional_encoding(
    x: torch.Tensor,
    num_freqs: int,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """Encode ``x[..., d] -> [..., embedding_dim]``."""
    if num_freqs == -1:
        return x
    if num_freqs == 0:
        return x if include_input else x[..., :0]
    if log_sampling and torch.compiler.is_exporting():
        # Traced: the same exact octaves from a device factory op, neither a
        # cached tensor (tracing would cache a fake one) nor a host constant.
        freqs = torch.full((num_freqs,), 2.0, dtype=x.dtype, device=x.device).cumprod(0) * 0.5
    elif log_sampling:
        freqs = _octaves(num_freqs, x.dtype, x.device)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (num_freqs - 1), num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]  # [..., F, d]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # [..., F, 2, d]
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        return torch.cat([x, enc], dim=-1)
    return enc
