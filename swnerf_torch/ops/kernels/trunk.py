"""Kernel B7: the NeRF field trunk on embedded inputs and its backward
(``csrc/trunk.cu``), its plain PyTorch twin, the weight packing and the
autograd function the D-NeRF field runs its canonical network through.

Replaces ``swnerf_tpu/ops/pallas/raymarch.py::_fwd_kernel`` /
``_bwd_kernel`` (``fused_trunk`` and its custom VJP ``_trunk_call``): raw
``[P, 4]`` (rgb logits, alpha; fp32) of a vanilla-architecture field at a
position embedding ``emb`` ``[P, cin <= 127]`` and a view embedding
``vemb`` ``[P, cv <= 128]`` computed outside, the ReLU family of
``fused_trunk``. Its backward gives every parameter gradient and, where
autograd asks, the embeddings' cotangents in fp32: ``demb`` carries the
D-NeRF loss into the deformation net (``need_input_grads=True`` in
``models/dnerf.py:182-204``), ``dvemb`` no caller needs.

``pack_trunk_params`` lays the weights out as ``render_pass.pack_params``
does (``render_pass.weight_layout``), with both embeddings padded to 128
rows: one buffer in the operand type, biases fp32.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from swnerf_torch.ops.kernels import build, launches
from swnerf_torch.ops.kernels.render_loss import field_reverse_plain, unpack_grads
from swnerf_torch.ops.kernels.render_pass import (
    WIDTHS,
    _check,
    _check_weights,
    bias_layout,
    field_mlp,
    layer,
    pack_buffers,
    quantizer,
    weight_layout,
)

NAME = "trunk"
CIN_PAD = 128  # padded position embedding: up to 127 live columns, room for the dW column of ones
CV_PAD = 128  # padded view embedding


def supports_trunk(cfg) -> bool:
    """The canonical networks B7 is built for (``raymarch.py::
    supports_config`` with this card's widths): view directions, one skip
    strictly inside the trunk, W in (128, 256), a position embedding within
    127 and a view embedding within 128 columns (Fourier or identity)."""
    return (
        cfg.use_viewdirs
        and cfg.netwidth in WIDTHS
        and len(cfg.skips) == 1
        and 0 < cfg.skips[0] < cfg.netdepth - 1
        and cfg.netdepth <= 16
        and cfg.input_ch < CIN_PAD
        and cfg.input_ch_views <= CV_PAD
    )


@dataclasses.dataclass(frozen=True)
class PackedTrunkParams:
    """A field trunk's weights packed for B7 and its twin."""

    weights: torch.Tensor  # 1-D, operand dtype (float32 or bfloat16)
    biases: torch.Tensor  # 1-D float32
    D: int
    W: int
    skip: int
    cin: int  # live position-embedding columns
    input_ch_views: int  # live view-embedding columns
    cin_pad = CIN_PAD
    cv_pad = CV_PAD
    arch = "vanilla"  # the ReLU family (render_pass.act)

    def matrices(self) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for name, rows, cols in weight_layout(self.D, self.W, self.skip, CIN_PAD, CV_PAD):
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
        """Multiply-adds per row of the forward of the unpadded network."""
        W, cin = self.W, self.cin
        trunk = cin * W + (self.D - 1) * W * W + cin * W  # layer 0, layers 1.., skip rows
        return trunk + W * W + W + (W + self.input_ch_views) * (W // 2) + (W // 2) * 3

    def bwd_macs_per_row(self, demb: bool = True, dvemb: bool = False) -> int:
        """The backward's multiply-adds per row: every dW (as many as the
        forward), the dH products of the heads and the trunk, and the
        embeddings' cotangents asked for."""
        W, WH = self.W, self.W // 2
        dh = WH * 3 + W * WH + W * W + W + (self.D - 1) * W * W
        return (self.macs_per_row + dh + (2 * self.cin * W if demb else 0)
                + (self.input_ch_views * WH if dvemb else 0))


def pack_trunk_params(state_dict: Mapping[str, torch.Tensor], cfg, dtype: torch.dtype = torch.bfloat16
                      ) -> PackedTrunkParams:
    """Pack a vanilla-architecture state dict (``pts_linears.{i}``,
    ``feature_linear``, ``alpha_linear``, ``views_linears.0``,
    ``rgb_linear``; torch ``[out, in]``) for B7. Plain torch ops, so packing
    the modules' own parameters in fp32 is differentiable. The result lies
    on the state dict's device."""
    if not supports_trunk(cfg):
        raise ValueError(f"trunk does not support {cfg}")
    trunk = [layer(state_dict, f"pts_linears.{i}") for i in range(cfg.netdepth)]
    heads = {k: layer(state_dict, key) for k, key in (
        ("feature", "feature_linear"), ("alpha", "alpha_linear"), ("views", "views_linears.0"), ("rgb", "rgb_linear"),
    )}
    weights, biases = pack_buffers(trunk, heads, cfg.skips[0], cfg.input_ch, CIN_PAD, CV_PAD, dtype)
    return PackedTrunkParams(weights, biases, cfg.netdepth, cfg.netwidth, cfg.skips[0], cfg.input_ch,
                             cfg.input_ch_views)


def unpack_trunk_grads(grads: Tuple[torch.Tensor, torch.Tensor], packed: PackedTrunkParams) -> Dict[str, torch.Tensor]:
    """B7's packed gradients -> the vanilla state-dict keys (padded rows
    dropped)."""
    return unpack_grads(grads, packed)


def _padded(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor):
    q, acc_dt = quantizer(packed)
    return (q(F.pad(emb.to(acc_dt), (0, CIN_PAD - emb.shape[-1]))),
            q(F.pad(vemb.to(acc_dt), (0, CV_PAD - vemb.shape[-1]))))


def trunk_plain(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor) -> torch.Tensor:
    """B7's forward in torch ops: raw [P, 4] (rgb logits, alpha) at emb
    [P, cin] and vemb [P, cv], rounded to the operand type where B7 rounds
    (the embeddings, each layer's output, feat, hv); float64 weights run it
    all in float64."""
    e, v = _padded(packed, emb, vemb)
    _, _, _, sigma, logits = field_mlp(packed, e, v)
    return torch.cat([logits, sigma[:, None]], -1)


def trunk_plain_bwd(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor, g: torch.Tensor,
                    need_demb: bool = True, need_dvemb: bool = False):
    """B7's backward in torch ops, from a recomputed forward: the packed
    fp32 gradients of ``sum(g * raw)`` for the cotangent g [P, 4], and
    (demb [P, cin], dvemb [P, cv]) in fp32 where asked (else None)."""
    _, acc_dt = quantizer(packed)
    e, v = _padded(packed, emb, vemb)
    hs, feat, hv, _, _ = field_mlp(packed, e, v)
    return field_reverse_plain(packed, e, v, hs, feat, hv, g.to(acc_dt), need_demb, need_dvemb)


def _lib_fn(name, restype, argtypes):
    fn = getattr(build.load(NAME), name)
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


def _bf16(packed: PackedTrunkParams) -> int:
    return int(packed.weights.dtype == torch.bfloat16)


def _scratch(packed: PackedTrunkParams, P: int, dev) -> torch.Tensor:
    i = ctypes.c_int
    nbytes = _lib_fn("trunk_scratch_bytes", ctypes.c_longlong, [i, i, i, ctypes.c_longlong])(
        _bf16(packed), packed.W, packed.D, P)
    if nbytes < 0:
        raise ValueError(f"trunk: unsupported width {packed.W}")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _launch_fwd(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor, scratch: Optional[torch.Tensor]):
    dev = emb.device
    P, cin = emb.shape
    if dev.type != "cuda" or packed.W not in WIDTHS or cin != packed.cin or vemb.shape[-1] != packed.input_ch_views:
        raise ValueError(f"trunk: unsupported call (device {dev}, W {packed.W}, emb {tuple(emb.shape)}, "
                         f"vemb {tuple(vemb.shape)})")
    _check(emb, "emb", (P, packed.cin), dev)
    _check(vemb, "vemb", (P, packed.input_ch_views), dev)
    _check_weights(packed, dev, "trunk")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _lib_fn("trunk_fwd_launch", ctypes.c_int, [i, i, p, i, p, i, p, p, i, i, ctypes.c_longlong, p, p, p])
    raw = torch.empty((P, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(
            _bf16(packed), packed.W, emb.data_ptr(), packed.cin, vemb.data_ptr(), packed.input_ch_views,
            packed.weights.data_ptr(), packed.biases.data_ptr(), packed.D, packed.skip, P, raw.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(build.load(NAME), code, "trunk")
    launches[NAME] += 1
    return raw


def _launch_bwd(packed: PackedTrunkParams, P: int, g: torch.Tensor, scratch: torch.Tensor, need_demb: bool,
                need_dvemb: bool):
    dev = g.device
    _check(g, "g", (P, 4), dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _lib_fn("trunk_bwd_launch", ctypes.c_int, [i, i, p, i, i, i, i, ctypes.c_longlong, p, p, p, p, p, p, p])
    gw = torch.zeros(packed.weights.numel(), dtype=torch.float32, device=dev)
    gb = torch.zeros(packed.biases.numel(), dtype=torch.float32, device=dev)
    demb = torch.empty((P, packed.cin), dtype=torch.float32, device=dev) if need_demb else None
    dvemb = torch.empty((P, packed.input_ch_views), dtype=torch.float32, device=dev) if need_dvemb else None
    with torch.cuda.device(dev):
        code = fn(
            _bf16(packed), packed.W, packed.weights.data_ptr(), packed.D, packed.skip, packed.cin,
            packed.input_ch_views, P, g.data_ptr(), gw.data_ptr(), gb.data_ptr(),
            demb.data_ptr() if demb is not None else None, dvemb.data_ptr() if dvemb is not None else None,
            scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(build.load(NAME), code, "trunk backward")
    launches[f"{NAME}[bwd]"] += 1
    return (gw, gb), demb, dvemb


def trunk(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor) -> torch.Tensor:
    """B7's forward on CUDA tensors (raw [P, 4] at emb [P, cin] and vemb
    [P, cv], fp32), the plain twin on CPU tensors."""
    if emb.device.type == "cpu":
        return trunk_plain(packed, emb, vemb)
    return _launch_fwd(packed, emb, vemb, None)


def trunk_fwd_bwd(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor, g: torch.Tensor,
                  need_demb: bool = True, need_dvemb: bool = False):
    """raw, the packed gradients of ``sum(g * raw)``, demb and dvemb (None
    where not asked) in one go: B7's train-mode forward and its backward on
    CUDA tensors, the twin on CPU tensors (how the card's checks compare the
    two)."""
    if emb.device.type == "cpu":
        return (trunk_plain(packed, emb, vemb), *trunk_plain_bwd(packed, emb, vemb, g, need_demb, need_dvemb))
    scratch = _scratch(packed, emb.shape[0], emb.device)
    raw = _launch_fwd(packed, emb, vemb, scratch)
    return (raw, *_launch_bwd(packed, emb.shape[0], g.contiguous(), scratch, need_demb, need_dvemb))


class _Trunk(torch.autograd.Function):
    """B7 under autograd. On the card the forward keeps the spilled
    activations (its scratch) for the backward kernel; on the CPU the twin's
    backward recomputes the forward. The parameters get gradients, and the
    embeddings where autograd asks for them."""

    @staticmethod
    def forward(ctx, weights, biases, emb, vemb, packed, dtype):
        run = dataclasses.replace(packed, weights=weights.detach().to(dtype).contiguous(),
                                  biases=biases.detach().contiguous())
        emb, vemb = emb.detach().contiguous(), vemb.detach().contiguous()
        ctx.run, ctx.emb, ctx.vemb = run, emb, vemb
        if emb.device.type == "cpu":
            ctx.scratch = None
            return trunk_plain(run, emb, vemb)
        ctx.scratch = _scratch(run, emb.shape[0], emb.device)
        return _launch_fwd(run, emb, vemb, ctx.scratch)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        need_demb, need_dvemb = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        if ctx.scratch is None:
            grads, demb, dvemb = trunk_plain_bwd(ctx.run, ctx.emb, ctx.vemb, g, need_demb, need_dvemb)
        else:
            grads, demb, dvemb = _launch_bwd(ctx.run, ctx.emb.shape[0], g, ctx.scratch, need_demb, need_dvemb)
        ctx.scratch = None
        return grads[0], grads[1], demb, dvemb, None, None


def trunk_autograd(packed: PackedTrunkParams, dtype: torch.dtype, emb: torch.Tensor, vemb: torch.Tensor
                   ) -> torch.Tensor:
    """Differentiable B7 with ``dtype`` operands: raw [P, 4]. ``packed``
    holds fp32 buffers packed differentiably from the modules' parameters
    (``pack_trunk_params(params, cfg, torch.float32)``), so autograd carries
    the kernel's packed gradients back to them; emb and vemb get their
    cotangents when they require gradients."""
    return _Trunk.apply(packed.weights, packed.biases, emb, vemb, packed, dtype)
