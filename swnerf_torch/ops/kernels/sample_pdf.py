"""Kernels B2, inverse-CDF importance sampling, and B10, the same with the
sorted union with the coarse depths (``csrc/sample_pdf.cu``), and their
plain PyTorch twins.

B2 replaces ``swnerf_tpu/ops/pallas/sample_pdf.py::_kernel``, B10
``_merge_kernel`` (``sample_pdf_merge_pallas``, the ``SWNERF_PDF_MERGE=1``
path). The uniforms ``u`` are built outside, as the JAX wrappers do
(``sample_pdf.py:103-109``, ``:266-275``). The twin sums in the kernel's
order (explicit sequential scans), so the two agree bit for bit on the
card; B10's samples are B2's, and its output is their sorted union with the
coarse depths whatever their order. The kernels count the cdf values <= u
by a binary search where the twins count them one by one, and B10 places
the union by co-ranks: :func:`count_le` and :func:`co_rank` are those
searches in torch, which ``tests/test_torch_pdf_merge.py`` holds to the
linear counts, and :func:`inverse_cdf` the step that turns the counts into
samples.

B2's wrapper :func:`sample_pdf` runs through the PyTorch op
``swnerf::sample_pdf`` (``torch.library.custom_op``, with a fake that gives
its shape), so a program exported by ``torch.export`` (``utils/export.py``)
launches B2 on the card; eager calls and the op's calls count alike in
``launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from swnerf_torch.ops.kernels import build, launches

NAME = "sample_pdf"


def cdf_plain(weights: torch.Tensor) -> torch.Tensor:
    """weights [N, M-1] -> the cdf [N, M] in the kernels' order: w = weights
    + 1e-5, its sum left to right, each w / sum added to a running sum from
    0."""
    w = weights + 1e-5  # prevent nans (reference ray.py:111)
    total = w[:, 0]
    for j in range(1, w.shape[-1]):
        total = total + w[:, j]
    pdf = w / total[:, None]
    cols = [torch.zeros_like(total)]
    for j in range(w.shape[-1]):
        cols.append(cols[-1] + pdf[:, j])
    return torch.stack(cols, -1)


def count_le(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """|{k : x[n, k] <= v[n, s]}| for x [N, M] non-decreasing along its rows
    and v [N, S], by the kernels' binary search (``csrc/sample_pdf.cu::count_le``):
    halving steps from the largest power of two <= M, each taken where the
    element it reaches is <= v."""
    M = x.shape[-1]
    pos = torch.zeros(v.shape, dtype=torch.long, device=v.device)
    step = 1 << (M.bit_length() - 1) if M else 0
    while step:
        p = pos + step
        pos = torch.where((p <= M) & (torch.gather(x, 1, p.clamp(max=M) - 1) <= v), p, pos)
        step >>= 1
    return pos


def co_rank(z: torch.Tensor, s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """How many of the sorted depths z [N, Mz] come first among the first d
    [N, D] elements of their union with the sorted samples s [N, S], ties
    to the depth, by B10's bisection (``csrc/sample_pdf.cu::co_rank``: the
    k with s[d - k - 1] >= z[k])."""
    Mz, S = z.shape[-1], s.shape[-1]
    lo, hi = (d - S).clamp(min=0), d.clamp(max=Mz)
    while bool((lo < hi).any()):
        k = (lo + hi) // 2
        live = lo < hi
        take = torch.gather(s, 1, (d - k - 1).clamp(0, S - 1)) >= torch.gather(z, 1, k.clamp(max=Mz - 1))
        lo = torch.where(live & take, k + 1, lo)
        hi = torch.where(live & ~take, k, hi)
    return lo


def inverse_cdf(cdf: torch.Tensor, bins: torch.Tensor, u: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """The kernels' inverse-CDF step (``csrc/sample_pdf.cu::inverse_cdf``):
    cdf and bins [N, M], u [N, S] and inds [N, S], the counts of cdf values
    <= u -> samples [N, S]: the below/above clamp, the denom < 1e-5 guard,
    the lerp."""
    M = bins.shape[-1]
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=M - 1)
    cdf_b = torch.gather(cdf, 1, below)
    cdf_a = torch.gather(cdf, 1, above)
    bins_b = torch.gather(bins, 1, below)
    bins_a = torch.gather(bins, 1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def sample_pdf_plain(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """bins [N, M], weights [N, M-1], u [N, S] -> samples [N, S] (fp32)."""
    cdf = cdf_plain(weights)  # [N, M]
    return inverse_cdf(cdf, bins, u, (cdf[:, None, :] <= u[:, :, None]).sum(-1))


def _row_stride(x: torch.Tensor, name: str) -> int:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name}: expected a 2-D float32 tensor, got {tuple(x.shape)} {x.dtype}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous")
    return x.stride(0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its launchers' signatures set, once."""
    lib = build.load(NAME)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.sample_pdf_f32.restype = lib.sample_pdf_merge_f32.restype = i32
    lib.sample_pdf_f32.argtypes = [ptr, i64] * 3 + [ptr] + [i32] * 3 + [ptr]
    lib.sample_pdf_merge_f32.argtypes = [ptr, i64] * 4 + [ptr] + [i32] * 4 + [ptr]
    lib.sample_pdf_merge_smem_bytes.restype = i64
    lib.sample_pdf_merge_smem_bytes.argtypes = [i32] * 3
    return lib


@torch.library.custom_op("swnerf::sample_pdf", mutates_args=())
def _sample_pdf_op(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """B2 as a PyTorch op: what :func:`sample_pdf` and an exported program
    call (``utils/export.py``)."""
    if bins.device.type == "cpu":
        return sample_pdf_plain(bins, weights, u)
    N, M = bins.shape
    S = u.shape[-1]
    if bins.device.type != "cuda" or weights.device != bins.device or u.device != bins.device:
        raise ValueError("sample_pdf: bins, weights and u must lie on one CUDA device")
    if weights.shape != (N, M - 1) or u.shape != (N, S) or not 2 <= M <= 1024:
        raise ValueError(
            f"sample_pdf: bad shapes bins {tuple(bins.shape)}, weights "
            f"{tuple(weights.shape)}, u {tuple(u.shape)} (need 2 <= M <= 1024)"
        )
    strides = [_row_stride(x, n) for x, n in ((bins, "bins"), (weights, "weights"), (u, "u"))]
    out = torch.empty((N, S), dtype=torch.float32, device=bins.device)
    lib = _lib()
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with torch.cuda.device(bins.device):
        code = lib.sample_pdf_f32(
            bins.data_ptr(), strides[0], weights.data_ptr(), strides[1], u.data_ptr(), strides[2],
            out.data_ptr(), N, M, S, stream,
        )
    build.check(lib, code, "sample_pdf")
    launches[NAME] += 1
    return out


@_sample_pdf_op.register_fake
def _(bins, weights, u):
    return u.new_empty((bins.shape[0], u.shape[-1]), dtype=torch.float32)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """B2 on CUDA tensors, the plain twin on CPU tensors; through the op
    ``swnerf::sample_pdf``."""
    return torch.ops.swnerf.sample_pdf(bins, weights, u)


MERGE_NAME = "sample_pdf_merge"


def sample_pdf_merge_plain(z_vals: torch.Tensor, bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor
                           ) -> torch.Tensor:
    """z_vals [N, Mz], bins [N, M], weights [N, M-1], u [N, S] -> the sorted
    union of z_vals and B2's samples, [N, Mz + S] (fp32)."""
    return torch.sort(torch.cat([z_vals, sample_pdf_plain(bins, weights, u)], -1), -1).values


def sample_pdf_merge(z_vals: torch.Tensor, bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor
                     ) -> torch.Tensor:
    """B10 on CUDA tensors, the plain twin on CPU tensors."""
    if bins.device.type == "cpu":
        return sample_pdf_merge_plain(z_vals, bins, weights, u)
    N, M = bins.shape
    S, Mz = u.shape[-1], z_vals.shape[-1]
    if any(x.device != bins.device for x in (weights, u, z_vals)) or bins.device.type != "cuda":
        raise ValueError("sample_pdf_merge: z_vals, bins, weights and u must lie on one CUDA device")
    lib = _lib()
    smem = lib.sample_pdf_merge_smem_bytes
    if weights.shape != (N, M - 1) or u.shape != (N, S) or z_vals.shape != (N, Mz) or not 2 <= M <= 1024 \
            or min(S, Mz) < 1 or smem(M, Mz, S) < 0:
        raise ValueError(
            f"sample_pdf_merge: bad shapes z_vals {tuple(z_vals.shape)}, bins {tuple(bins.shape)}, weights "
            f"{tuple(weights.shape)}, u {tuple(u.shape)}"
        )
    strides = [_row_stride(x, n) for x, n in ((bins, "bins"), (weights, "weights"), (u, "u"), (z_vals, "z_vals"))]
    out = torch.empty((N, Mz + S), dtype=torch.float32, device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with torch.cuda.device(bins.device):
        code = lib.sample_pdf_merge_f32(
            bins.data_ptr(), strides[0], weights.data_ptr(), strides[1], u.data_ptr(), strides[2],
            z_vals.data_ptr(), strides[3], out.data_ptr(), N, M, Mz, S, stream,
        )
    build.check(lib, code, "sample_pdf_merge")
    launches[MERGE_NAME] += 1
    return out
