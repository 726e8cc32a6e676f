"""Kernel B6: the D-NeRF deformation MLP and its backward
(``csrc/time_net.cu``), its plain PyTorch twin, the weight packing and the
autograd function the train step uses.

Replaces ``swnerf_tpu/ops/pallas/raymarch.py::_fwd_kernel_plain`` /
``_bwd_kernel_plain`` (``fused_time_net`` and its custom VJP): ``dx =
MLP([embed(x) | embed(t)])`` with ReLU layers, a skip that concatenates
``embed(x)`` only, and a 3-wide head. B6 encodes in-block from the sample
positions ``pts`` [N, S, 3] and the per-ray times [N], with its own
position and time frequency counts (0: the identity, a MultiRes level's
``-1``), which is what B11 (``raymarch.py::fused_time_net_pts``) computes
too: :func:`fused_time_net_pts` runs B6's forward launch and, with
``need_input_grads``, B11's backward, which also forms the fp32 cotangent
of ``[embed(x) | embed(t)]`` and chains it through the encode to d pts and
d times (``_bwd_kernel_plain_raw``, raymarch.py:519-553). The product
callers feed the positions detached (fused_step.py:478-481, 499-503;
models/dnerf.py:264-268) and form no input cotangent, as in the JAX
package, where ``fused_time_net_pts`` has no product caller either.

The forward-only wrapper :func:`time_net` runs through the PyTorch op
``swnerf::time_net`` (``torch.library.custom_op``, with a fake that gives
its shape), so a program exported by ``torch.export`` (``utils/export.py``)
calls B6; eager calls and the op's calls count alike in ``launches``.

``pack_time_params`` is the port of ``raymarch.py::pack_time_params``
(:786-816) for this card: one buffer in the operand type, each matrix
``[in, out]`` row-major, the input padded to 96 rows (D-NeRF's multires 10:
84 live columns; MultiRes levels 1-3) or 144 (MultiRes level 0's (20, 8):
140), the skip layer split into its embedding rows (the ``embed(t)`` rows
zero, so the shared body ignores the time columns exactly) and its hidden
rows; biases fp32.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import build, launches
from swnerf_torch.ops.kernels.render_pass import CIN_PAD_T, WIDTHS, _check

NAME = "time_net"
CIN_PAD_WIDE = 144  # MultiRes level 0: 123 + 17 = 140 live columns


def cin_pad_of(cin: int) -> int:
    """The padded input width B6 is instantiated for: 96, or 144 above 95
    live columns (one row stays free for the dW column of ones)."""
    return CIN_PAD_T if cin < CIN_PAD_T else CIN_PAD_WIDE


def supports_time_net(cfg) -> bool:
    """The deformation MLPs B6 is built for: Fourier encoding or the
    identity, any position and time frequency counts whose input fits 143 of
    the 144 padded rows, W in (128, 256), one skip strictly inside the
    trunk."""
    return (
        cfg.i_embed in (0, -1)
        and cfg.netwidth in WIDTHS
        and cfg.input_ch + cfg.input_ch_time < CIN_PAD_WIDE
        and len(cfg.skips) == 1
        and 0 < cfg.skips[0] < cfg.netdepth - 1
        and cfg.netdepth <= 16
    )


def weight_layout(D: int, W: int, skip: int, cin_pad: int = CIN_PAD_T) -> List[Tuple[str, int, int]]:
    """(name, rows, cols) of each packed matrix, in buffer order (the
    kernel walks the same order, gemm_common.cuh::trunk_offsets)."""
    out = [("pts0", cin_pad, W)]
    for i in range(1, D):
        if i == skip + 1:
            out.append((f"pts{i}_emb", cin_pad, W))
        out.append((f"pts{i}", W, W))
    return out + [("out", W, 3)]


def bias_layout(D: int, W: int) -> List[Tuple[str, int]]:
    return [(f"pts{i}", W) for i in range(D)] + [("out", 3)]


@dataclasses.dataclass(frozen=True)
class PackedTimeParams:
    """A deformation MLP's weights packed for B6 and its twin."""

    weights: torch.Tensor  # 1-D, operand dtype (float32 or bfloat16)
    biases: torch.Tensor  # 1-D float32
    D: int
    W: int
    skip: int
    n_freqs: int  # position-encoding frequencies (0: the identity)
    n_freqs_time: int  # time-encoding frequencies (0: the identity)

    @property
    def input_ch(self) -> int:
        return 3 + 6 * self.n_freqs

    @property
    def cin(self) -> int:
        """Live input columns: embed(xyz), then embed(t)."""
        return self.input_ch + 1 + 2 * self.n_freqs_time

    @property
    def cin_pad(self) -> int:
        return cin_pad_of(self.cin)

    def matrices(self) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for name, rows, cols in weight_layout(self.D, self.W, self.skip, self.cin_pad):
            out[name] = self.weights[off : off + rows * cols].view(rows, cols)
            off += rows * cols
        return out

    def bias_vectors(self) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for name, n in bias_layout(self.D, self.W):
            out[name] = self.biases[off : off + n]
            off += n
        return out

    @property
    def macs_per_row(self) -> int:
        """Multiply-adds per row of the forward (the skip layer's embedding
        rows count embed(x) only)."""
        W = self.W
        return self.cin * W + (self.D - 1) * W * W + self.input_ch * W + W * 3

    @property
    def bwd_macs_per_row(self) -> int:
        """The backward's multiply-adds per row: every dW (as many as the
        forward) and the dH products (no input cotangent)."""
        return self.macs_per_row + (self.D - 1) * self.W * self.W + self.W * 3

    @property
    def din_macs_per_row(self) -> int:
        """B11's backward: B6's and the input cotangent (dz_0 W_0^T over
        every live column, dz_{skip+1} W_emb^T over embed(x)'s)."""
        return self.bwd_macs_per_row + (self.cin + self.input_ch) * self.W


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    return F.pad(w, (0, 0, 0, rows - w.shape[0]))


def pack_time_params(params: Mapping[str, torch.Tensor], cfg, dtype: torch.dtype = torch.bfloat16,
                     prefix: str = "_time") -> PackedTimeParams:
    """Pack the deformation MLP of a D-NeRF state dict or parameter dict
    (``{prefix}.{i}.weight`` ``[out, in]``, ``{prefix}_out.*``). Plain torch
    ops, so packing ``dict(model.named_parameters())`` in fp32 is
    differentiable. The result lies on the parameters' device."""
    if not supports_time_net(cfg):
        raise ValueError(f"time_net does not support {cfg}")
    D, W, skip, cin_x = cfg.netdepth, cfg.netwidth, cfg.skips[0], cfg.input_ch
    cin_pad = cin_pad_of(cin_x + cfg.input_ch_time)
    mats = {}
    for i in range(D):
        w = params[f"{prefix}.{i}.weight"].to(torch.float32).t()  # [in, out]
        if i == 0:
            mats["pts0"] = _pad_rows(w, cin_pad)
        elif i == skip + 1:  # [embed(x) | h]: embed(x)'s rows, then zero rows where embed(t) sits
            mats[f"pts{i}_emb"] = _pad_rows(w[:cin_x], cin_pad)
            mats[f"pts{i}"] = w[cin_x:]
        else:
            mats[f"pts{i}"] = w
    mats["out"] = params[f"{prefix}_out.weight"].to(torch.float32).t()
    flat = []
    for name, rows, cols in weight_layout(D, W, skip, cin_pad):
        if tuple(mats[name].shape) != (rows, cols):
            raise ValueError(f"{name}: shape {tuple(mats[name].shape)} != {(rows, cols)}")
        flat.append(mats[name].reshape(-1))
    biases = [params[f"{prefix}.{i}.bias"].to(torch.float32) for i in range(D)]
    biases.append(params[f"{prefix}_out.bias"].to(torch.float32))
    return PackedTimeParams(
        weights=torch.cat(flat).to(dtype).contiguous(), biases=torch.cat(biases).contiguous(),
        D=D, W=W, skip=skip, n_freqs=max(cfg.nf_pts, 0), n_freqs_time=max(cfg.nf_time, 0),
    )


def unpack_time_grads(grads: Tuple[torch.Tensor, torch.Tensor], packed: PackedTimeParams,
                      prefix: str = "_time") -> Dict[str, torch.Tensor]:
    """Packed gradient buffers -> ``{state-dict key: [out, in] grad}``; the
    padded rows (embed(t)'s rows of the skip block among them) are dropped."""
    gw, gb = grads
    mats, off = {}, 0
    for name, rows, cols in weight_layout(packed.D, packed.W, packed.skip, packed.cin_pad):
        mats[name] = gw[off : off + rows * cols].view(rows, cols)
        off += rows * cols
    out = {}
    for i in range(packed.D):
        if i == 0:
            w = mats["pts0"][: packed.cin]
        elif i == packed.skip + 1:
            w = torch.cat([mats[f"pts{i}_emb"][: packed.input_ch], mats[f"pts{i}"]], 0)
        else:
            w = mats[f"pts{i}"]
        out[f"{prefix}.{i}.weight"] = w.t().contiguous()
        out[f"{prefix}.{i}.bias"] = gb[i * packed.W : (i + 1) * packed.W].clone()
    out[f"{prefix}_out.weight"] = mats["out"].t().contiguous()
    out[f"{prefix}_out.bias"] = gb[packed.D * packed.W :].clone()
    return out


def _forward(packed: PackedTimeParams, pts: torch.Tensor, times: torch.Tensor, keep: bool = True):
    """The twin's forward: (emb, each layer's output (with ``keep``; else
    none), dx [P, 3]), rounded to the operand type exactly where B6 rounds
    (the embedding, each layer's output); products and sums fp32 (float64
    weights: all float64)."""
    cdt = packed.weights.dtype
    acc_dt = torch.float64 if cdt == torch.float64 else torch.float32
    m = {k: v.to(acc_dt) for k, v in packed.matrices().items()}
    b = packed.bias_vectors()
    N, S, _ = pts.shape
    P = N * S

    def q(x):
        return x.to(cdt).to(acc_dt)

    t = times.reshape(N, 1, 1).expand(N, S, 1).reshape(P, 1)
    emb = torch.cat([positional_encoding(pts.reshape(P, 3), packed.n_freqs),
                     positional_encoding(t, packed.n_freqs_time)], -1)
    emb = q(F.pad(emb, (0, packed.cin_pad - emb.shape[-1])))
    hs = []
    h = emb
    for i in range(packed.D):
        z = h @ m[f"pts{i}"]
        if i == packed.skip + 1:
            z = emb @ m[f"pts{i}_emb"] + z
        h = q(torch.relu(z + b[f"pts{i}"]))
        if keep:
            hs.append(h)
    return emb, hs, h @ m["out"] + b["out"]


def time_net_plain(packed: PackedTimeParams, pts: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """B6's forward in torch ops: dx [N, S, 3] at pts [N, S, 3] and per-ray
    times [N]."""
    return _forward(packed, pts, times, keep=False)[2].reshape(pts.shape)


def encode_xt_backward(pts: torch.Tensor, times: torch.Tensor, demb: torch.Tensor, n_freqs: int,
                       n_freqs_time: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """d pts [N, S, 3] and d times [N] from the cotangent ``demb`` [N*S,
    cin] of ``[embed(x) | embed(t)]`` (positional_encoding's columns; 0
    frequencies: the identity), in the kernel's order of sums
    (``raymarch.py::_embed_bwd``, which takes cos's derivative as
    cos(u + pi/2)); d times adds each ray's samples."""
    N, S, _ = pts.shape
    x = pts.reshape(-1, 3).to(demb.dtype)
    s = demb[:, 0:3]
    for f in range(n_freqs):
        scale = float(2**f)
        u = x * scale
        c = 3 + 6 * f
        s = s + scale * (torch.cos(u) * demb[:, c : c + 3] - torch.sin(u) * demb[:, c + 3 : c + 6])
    dpos = 3 + 6 * n_freqs
    t = times.reshape(N, 1).expand(N, S).reshape(-1).to(demb.dtype)
    dt = demb[:, dpos]
    for f in range(n_freqs_time):
        scale = float(2**f)
        u = t * scale
        c = dpos + 1 + 2 * f
        dt = dt + scale * (torch.cos(u) * demb[:, c] - torch.sin(u) * demb[:, c + 1])
    return s.reshape(N, S, 3), dt.reshape(N, S).sum(-1)


def time_net_plain_bwd(
    packed: PackedTimeParams, pts: torch.Tensor, times: torch.Tensor, g: torch.Tensor,
    need_input_grads: bool = False,
):
    """B6's backward in torch ops: the packed fp32 gradients (weights in
    ``weight_layout``, biases in ``bias_layout`` order) of ``sum(g * dx)``
    for the cotangent g [N, S, 3], from a recomputed forward.
    ``_trunk_backward``'s plain head: q(g) into dW_out and dH, the fp32 g
    into db_out, every dz rounded. With ``need_input_grads`` (B11) it
    returns ``(grads, dpts [N, S, 3], dtimes [N])``: the fp32 embedding
    cotangent (dz_{skip+1} W_emb^T, then + dz_0 W_0^T over the live
    columns) through :func:`encode_xt_backward`."""
    cdt = packed.weights.dtype
    acc_dt = torch.float64 if cdt == torch.float64 else torch.float32
    m = {k: v.to(acc_dt) for k, v in packed.matrices().items()}
    emb, hs, _ = _forward(packed, pts, times)
    g = g.reshape(-1, 3).to(acc_dt)
    gq = g.to(cdt).to(acc_dt)

    def q(x):
        return x.to(cdt).to(acc_dt)

    gw: Dict[str, torch.Tensor] = {"out": hs[-1].t() @ gq}
    gb: Dict[str, torch.Tensor] = {"out": g.sum(0)}
    dz = q(torch.where(hs[-1] > 0, gq @ m["out"].t(), torch.zeros_like(hs[-1])))
    for i in range(packed.D - 1, -1, -1):
        if i == packed.skip + 1:
            gw[f"pts{i}_emb"] = emb.t() @ dz
        gw[f"pts{i}"] = (emb if i == 0 else hs[i - 1]).t() @ dz
        gb[f"pts{i}"] = dz.sum(0)
        if need_input_grads and i == packed.skip + 1:
            demb = dz @ m[f"pts{i}_emb"].t()
        if i > 0:
            dz = q(torch.where(hs[i - 1] > 0, dz @ m[f"pts{i}"].t(), torch.zeros_like(hs[i - 1])))
        elif need_input_grads:
            demb = demb + dz @ m["pts0"].t()
    grads = (
        torch.cat([gw[n].reshape(-1) for n, _, _ in weight_layout(packed.D, packed.W, packed.skip, packed.cin_pad)]),
        torch.cat([gb[n].reshape(-1) for n, _ in bias_layout(packed.D, packed.W)]),
    )
    if not need_input_grads:
        return grads
    return (grads, *encode_xt_backward(pts, times, demb[:, : packed.cin], packed.n_freqs, packed.n_freqs_time))


def _lib_fn(lib, name, restype, argtypes):
    fn = getattr(lib, name)
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


def _launch_fwd(packed: PackedTimeParams, pts: torch.Tensor, times: torch.Tensor, scratch: Optional[torch.Tensor]):
    N, S, _ = pts.shape
    dev = pts.device
    if dev.type != "cuda" or packed.W not in WIDTHS:
        raise ValueError(f"time_net: unsupported call (device {dev}, W {packed.W})")
    _check(pts, "pts", (N, S, 3), dev)
    _check(times, "times", (N,), dev)
    if (
        packed.weights.device != dev
        or packed.biases.device != dev
        or packed.weights.data_ptr() % 16
        or packed.weights.dtype not in (torch.float32, torch.bfloat16)
    ):
        raise ValueError("time_net: packed weights must be a 16-byte aligned fp32/bf16 buffer on the device")
    lib = build.load(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _lib_fn(lib, "time_net_fwd_launch", ctypes.c_int,
                 [i, i, i, p, p, p, p, i, i, i, i, i, i, p, p, p, ctypes.c_longlong, p])
    dx = torch.empty((N, S, 3), dtype=torch.float32, device=dev)
    bf16 = int(packed.weights.dtype == torch.bfloat16)
    size_fn = _lib_fn(lib, "time_net_image_bytes", ctypes.c_longlong, [i, i, i, i, i])
    img_bytes = size_fn(bf16, packed.cin_pad, packed.W, packed.D, packed.skip)  # the bf16 weight image, else 0
    img = torch.empty(img_bytes, dtype=torch.uint8, device=dev) if img_bytes else None
    with torch.cuda.device(dev):
        code = fn(
            bf16, packed.W, packed.cin_pad, pts.data_ptr(), times.data_ptr(),
            packed.weights.data_ptr(), packed.biases.data_ptr(), packed.D, packed.skip, packed.n_freqs,
            packed.n_freqs_time, N, S, dx.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            img.data_ptr() if img is not None else None, img_bytes, torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "time_net")
    launches[NAME] += 1
    return dx


@torch.library.custom_op("swnerf::time_net", mutates_args=())
def _time_net_op(weights: torch.Tensor, biases: torch.Tensor, pts: torch.Tensor, times: torch.Tensor, D: int, W: int,
                 skip: int, n_freqs: int, n_freqs_time: int) -> torch.Tensor:
    """B6's forward as a PyTorch op: what an exported program calls
    (``utils/export.py``)."""
    packed = PackedTimeParams(weights, biases, D, W, skip, n_freqs, n_freqs_time)
    if pts.device.type == "cpu":
        return time_net_plain(packed, pts, times)
    return _launch_fwd(packed, pts, times, None)


@_time_net_op.register_fake
def _(weights, biases, pts, times, D, W, skip, n_freqs, n_freqs_time):
    return pts.new_empty(pts.shape, dtype=torch.float64 if weights.dtype == torch.float64 else torch.float32)


def time_net(packed: PackedTimeParams, pts: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """B6's forward on CUDA tensors (dx [N, S, 3] at pts [N, S, 3] and
    per-ray times [N]), the plain twin on CPU tensors; through the op
    ``swnerf::time_net``."""
    return torch.ops.swnerf.time_net(packed.weights, packed.biases, pts, times, packed.D, packed.W, packed.skip,
                                     packed.n_freqs, packed.n_freqs_time)


def _scratch(packed: PackedTimeParams, M: int, dev) -> torch.Tensor:
    lib = build.load(NAME)
    i = ctypes.c_int
    fn = _lib_fn(lib, "time_net_scratch_bytes", ctypes.c_longlong, [i, i, i, i, ctypes.c_longlong])
    nbytes = fn(int(packed.weights.dtype == torch.bfloat16), packed.cin_pad, packed.W, packed.D, M)
    if nbytes < 0:
        raise ValueError(f"time_net: unsupported width {packed.W} or input {packed.cin}")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _din_scratch(packed: PackedTimeParams, M: int, dev) -> torch.Tensor:
    """B11's train-mode scratch: B6's, then the fp32 embedding cotangent
    and the per-row d t."""
    lib = build.load(NAME)
    i = ctypes.c_int
    fn = _lib_fn(lib, "time_net_din_scratch_bytes", ctypes.c_longlong, [i, i, i, i, i, i, ctypes.c_longlong])
    nbytes = fn(int(packed.weights.dtype == torch.bfloat16), packed.cin_pad, packed.W, packed.D, packed.n_freqs,
                packed.n_freqs_time, M)
    if nbytes < 0:
        raise ValueError(f"time_net: unsupported width {packed.W} or input {packed.cin}")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _launch_bwd_din(packed: PackedTimeParams, pts: torch.Tensor, times: torch.Tensor, g: torch.Tensor,
                    scratch: torch.Tensor):
    """B11's backward launch: the packed gradients, d pts and d times."""
    N, S, _ = pts.shape
    dev = g.device
    _check(g, "g", (N * S, 3), dev)
    lib = build.load(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _lib_fn(lib, "time_net_bwd_din_launch", ctypes.c_int, [i, i, i, p, i, i, i, i, i, i] + [p] * 9)
    gw = torch.zeros(packed.weights.numel(), dtype=torch.float32, device=dev)
    gb = torch.zeros(packed.biases.numel(), dtype=torch.float32, device=dev)
    dpts = torch.empty((N, S, 3), dtype=torch.float32, device=dev)
    dtimes = torch.empty((N,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(
            int(packed.weights.dtype == torch.bfloat16), packed.W, packed.cin_pad, packed.weights.data_ptr(),
            packed.D, packed.skip, packed.n_freqs, packed.n_freqs_time, N, S, pts.data_ptr(), times.data_ptr(),
            g.data_ptr(), gw.data_ptr(), gb.data_ptr(), dpts.data_ptr(), dtimes.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "time_net backward (input grads)")
    launches[f"{NAME}[pts,bwd]"] += 1
    return (gw, gb), dpts, dtimes


def _launch_bwd(packed: PackedTimeParams, M: int, g: torch.Tensor, scratch: torch.Tensor):
    dev = g.device
    _check(g, "g", (M, 3), dev)
    lib = build.load(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _lib_fn(lib, "time_net_bwd_launch", ctypes.c_int,
                 [i, i, i, p, i, i, i, i, ctypes.c_longlong, p, p, p, p, p])
    gw = torch.zeros(packed.weights.numel(), dtype=torch.float32, device=dev)
    gb = torch.zeros(packed.biases.numel(), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(
            int(packed.weights.dtype == torch.bfloat16), packed.W, packed.cin_pad, packed.weights.data_ptr(),
            packed.D, packed.skip, packed.n_freqs, packed.n_freqs_time, M, g.data_ptr(), gw.data_ptr(),
            gb.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "time_net backward")
    launches[f"{NAME}[bwd]"] += 1
    return gw, gb


def time_net_fwd_bwd(
    packed: PackedTimeParams, pts: torch.Tensor, times: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """dx and the packed gradients of ``sum(g * dx)`` in one go: B6's
    train-mode forward and its backward on CUDA tensors, the twin on CPU
    tensors (how the card's checks compare the two)."""
    if pts.device.type == "cpu":
        return time_net_plain(packed, pts, times), time_net_plain_bwd(packed, pts, times, g)
    M = pts.shape[0] * pts.shape[1]
    scratch = _scratch(packed, M, pts.device)
    dx = _launch_fwd(packed, pts, times, scratch)
    return dx, _launch_bwd(packed, M, g.reshape(M, 3).contiguous(), scratch)


class _TimeNet(torch.autograd.Function):
    """B6 under autograd, and B11 with ``din``. On the card the forward
    keeps the spilled activations (its scratch) for the backward kernel; on
    the CPU the twin's backward recomputes the forward. Without ``din`` only
    the parameters get gradients; with it also pts and times."""

    @staticmethod
    def forward(ctx, weights, biases, packed, dtype, pts, times, din=False):
        run = dataclasses.replace(packed, weights=weights.detach().to(dtype).contiguous(),
                                  biases=biases.detach().contiguous())
        pts, times = pts.detach().contiguous(), times.detach().contiguous()
        ctx.run, ctx.pts, ctx.times, ctx.din = run, pts, times, din
        if pts.device.type == "cpu":
            ctx.scratch = None
            return time_net_plain(run, pts, times)
        M = pts.shape[0] * pts.shape[1]
        ctx.scratch = _din_scratch(run, M, pts.device) if din else _scratch(run, M, pts.device)
        return _launch_fwd(run, pts, times, ctx.scratch)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dpts = dtimes = None
        M = ctx.pts.shape[0] * ctx.pts.shape[1]
        if ctx.scratch is None:
            out = time_net_plain_bwd(ctx.run, ctx.pts, ctx.times, g, ctx.din)
            (gw, gb), dpts, dtimes = out if ctx.din else (out, None, None)
        elif ctx.din:
            (gw, gb), dpts, dtimes = _launch_bwd_din(ctx.run, ctx.pts, ctx.times, g.reshape(M, 3), ctx.scratch)
        else:
            gw, gb = _launch_bwd(ctx.run, M, g.reshape(M, 3), ctx.scratch)
        ctx.scratch = None
        return gw, gb, None, None, dpts, dtimes, None


def time_net_autograd(packed: PackedTimeParams, dtype: torch.dtype, pts: torch.Tensor, times: torch.Tensor
                      ) -> torch.Tensor:
    """Differentiable B6 with ``dtype`` operands: dx [N, S, 3]. ``packed``
    holds fp32 buffers packed differentiably from the modules' parameters
    (``pack_time_params(dict(model.named_parameters()), cfg,
    torch.float32)``), so autograd carries the kernel's packed gradients back
    to them. pts and times enter detached."""
    return _TimeNet.apply(packed.weights, packed.biases, packed, dtype, pts, times)


def fused_time_net_pts(packed: PackedTimeParams, pts: torch.Tensor, times: torch.Tensor,
                       need_input_grads: bool = False, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """B11 (``raymarch.py::fused_time_net_pts``): dx [N, S, 3] at the raw
    positions pts [N, S, 3] and per-ray times [N], the encode in the
    kernel, differentiable in ``packed``'s buffers (``dtype`` operands;
    None: the buffers' own type). Its forward is B6's launch. Without
    ``need_input_grads`` the backward is B6's and pts and times enter
    detached, exactly as :func:`time_net_autograd`; with it the backward
    also hands back d pts and d times (B11). No product path calls it, as in
    the JAX package."""
    return _TimeNet.apply(packed.weights, packed.biases, packed, dtype or packed.weights.dtype, pts, times,
                          need_input_grads)
