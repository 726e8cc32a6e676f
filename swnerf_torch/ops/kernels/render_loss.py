"""Kernels B1 and B4 (train mode): the train-mode render pass of a vanilla
NeRF and of a T-NeRF (``csrc/render_loss.cu``), their plain PyTorch twin,
and the gradient unpacking.

Replaces ``swnerf_tpu/ops/pallas/render_fused.py::_render_loss_kernel`` in
train mode (``param_grads=True``, ``from_rays``), arch ``"vanilla"`` (B1)
or ``"tnerf"`` (B4): B3's / B4's forward, the per-ray squared error
``sqerr_r = sum_c (rgb_map_rc - target_rc)^2`` after the white background,
the compositing backward and the trunk reverse. The gradients are those of
``loss_scale * sum_r sqerr_r`` and come out of the kernel itself, as in the
JAX package; nothing here goes through autograd. B4's reverse takes ELU'
from each stored activation (``h > 0 ? 1 : h + 1``) and masks the colour
cotangent with its ReLU (``[logit > 0]``). With bf16 weights the forward
runs on the tensor cores (``csrc/tc_render.cuh::render_loss_tc_kernel``,
its rgb / acc / depth / weights bit-equal to :func:`render_pass`'s bf16
launch) and so does the reverse sweep's products (``csrc/tc_gemm.cuh``);
fp32 weights keep the SIMT body.

B9 (``render_loss_ext``, the backward half of
``train/fused_step.py::make_render_outputs``; render_fused.py's
``ext_ct=True``) is B5 with the caller's per-ray cotangent of (rgb_map, acc,
depth) in place of the squared error's, at the narrow or the wide pads:
:func:`render_outputs_autograd` runs B3's pts mode forward and B9 as its
backward, so a loss the kernel cannot form (MultiRes' pyramid
reconstruction) still trains the field through the kernels.

Weights arrive packed by ``render_pass.pack_params`` /
``pack_tnerf_params``; the gradients come back as one fp32 buffer in
``weight_layout`` order and one in ``bias_layout`` order, which
:func:`unpack_grads` / :func:`unpack_tnerf_grads` map to each
``nn.Linear``'s ``[out, in]`` gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from swnerf_torch.ops.kernels import build, launches
from swnerf_torch.ops.kernels.render_pass import (
    WIDTHS,
    PackedParams,
    RenderPassOutput,
    _check,
    _check_weights,
    bias_layout,
    check_pts,
    check_samples,
    check_times,
    colour,
    field_forward,
    launch_key,
    quantizer,
    render_pass,
    render_pass_plain,
    weight_layout,
)

NAME = "render_loss"


class RenderLossOutput(NamedTuple):
    rgb: torch.Tensor  # [N, 3], white-composited when asked
    acc: torch.Tensor  # [N]
    depth: torch.Tensor  # [N]
    sqerr: torch.Tensor  # [N]
    weights: torch.Tensor  # [N, S]


Grads = Tuple[torch.Tensor, torch.Tensor]  # (weights in weight_layout, biases in bias_layout), fp32


def train_macs_per_sample(packed: PackedParams) -> int:
    """Multiply-adds per sample of one train-mode pass of the unpadded
    network: the forward, every dW (as many as the forward) and the dX
    products the reverse sweep needs (no input gradients)."""
    W, D = packed.W, packed.D
    dx = (W // 2) * 3 + W * (W // 2) + W * W + W + (D - 1) * W * W
    return 2 * packed.macs_per_sample + dx


def pts_train_macs_per_sample(packed: PackedParams) -> int:
    """B5's multiply-adds per sample: B1's and the embedding's cotangent
    (dz_0 W_0^T and dz_{skip+1} W_emb^T over the live columns)."""
    return train_macs_per_sample(packed) + 2 * packed.cin * packed.W


def _excl_suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """sum_{c > b} x_c along the last axis."""
    rev = torch.cumsum(x.flip(-1), -1)
    return torch.cat([torch.zeros_like(rev[..., :1]), rev[..., :-1]], -1).flip(-1)


def _through_act(dh: torch.Tensor, h: torch.Tensor, arch: str) -> torch.Tensor:
    """``dh`` times the activation's derivative, taken from its output
    ``h`` (rounded to the operand type): ReLU ``[h > 0]``; ELU
    ``h > 0 ? 1 : h + 1`` (``raymarch.py::_act_grad``)."""
    if arch == "tnerf":
        return dh * torch.where(h > 0, torch.ones_like(h), h + 1.0)
    return torch.where(h > 0, dh, torch.zeros_like(dh))


def render_loss_plain(
    packed: PackedParams,
    origins: torch.Tensor,
    directions: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor],
    target: torch.Tensor,
    white_bkgd: bool,
    loss_scale: float,
    times: Optional[torch.Tensor] = None,
) -> Tuple[RenderLossOutput, Grads]:
    """B1's / B4's arithmetic in torch ops, with the backward written out
    (render_fused.py:442-478 and ``_trunk_reverse``). With bf16 weights it
    rounds to bf16 exactly where the kernel does: the embedding, each layer's
    output, feat, hv, the raw cotangent (g_rgb, d sigma), dhv, d feat and
    every dz. Products and sums stay fp32; the per-sample colour is fp32.
    float64 weights run it all in float64 (a reference for conditioning
    checks)."""
    out, grads, _ = _twin(packed, origins, directions, views_emb, z_vals, dists, noise, target, white_bkgd, loss_scale,
                          times)
    return out, grads


def encode_backward(x: torch.Tensor, demb: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """d loss / d x [P, 3] from the cotangent ``demb`` of its Fourier
    encoding (positional_encoding's columns: x, then sin(2^f x), cos(2^f x)
    per frequency), in the kernel's order of sums (raymarch.py::_embed_bwd,
    which takes cos's derivative as cos(u + pi/2))."""
    s = demb[:, 0:3]
    for f in range(n_freqs):
        scale = float(2**f)
        u = x * scale
        c = 3 + 6 * f
        s = s + scale * (torch.cos(u) * demb[:, c : c + 3] - torch.sin(u) * demb[:, c + 3 : c + 6])
    return s


def render_loss_pts_plain(
    packed: PackedParams,
    pts: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor],
    target: torch.Tensor,
    white_bkgd: bool,
    loss_scale: float,
) -> Tuple[RenderLossOutput, Grads, torch.Tensor]:
    """B5's arithmetic: :func:`render_loss_plain` on given positions ``pts``
    [N, S, 3] (a vanilla field), and ``dpts`` [N, S, 3] = d(loss_scale *
    sum sqerr) / d pts. The embedding's cotangent is fp32 (dz_{skip+1}
    W_emb^T, then + dz_0 W_0^T over the live columns) and goes through
    :func:`encode_backward`."""
    return _twin(packed, None, None, views_emb, z_vals, dists, noise, target, white_bkgd, loss_scale, None, pts)


def field_reverse_plain(packed, emb, vemb, hs, feat, hv, graw, need_demb: bool = False, need_dvemb: bool = False):
    """The field's reverse sweep from the raw cotangent ``graw`` [P, 4]
    (d rgb logits, d sigma), written out as gemm_common.cuh::field_reverse
    runs it (render_fused.py:442-478, raymarch.py::_trunk_backward): the
    packed fp32 gradients (weights in ``weight_layout``, biases in
    ``bias_layout`` order) and, where asked, the fp32 cotangents of the
    embeddings over the live columns, demb [P, cin] (dz_{skip+1} W_emb^T,
    then + dz_0 W_0^T) and dvemb [P, cv]. ``emb``, ``vemb``, ``hs``,
    ``feat``, ``hv`` are the forward's rounded operands (:func:`field_mlp`);
    q(graw), dhv, d feat and every dz are rounded where the kernels round."""
    q, acc_dt = quantizer(packed)
    m = {k: v.to(acc_dt) for k, v in packed.matrices().items()}
    D, skip, arch = packed.D, packed.skip, packed.arch
    gq = q(graw)
    gw: Dict[str, torch.Tensor] = {}
    gb: Dict[str, torch.Tensor] = {}
    dhv = _through_act(gq[:, :3] @ m["rgb"].t(), hv, arch)
    dhv_c = q(dhv)
    gw["rgb"], gb["rgb"] = hv.t() @ gq[:, :3], graw[:, :3].sum(0)
    gw["views_feat"], gw["views_emb"], gb["views"] = feat.t() @ dhv_c, vemb.t() @ dhv_c, dhv.sum(0)
    dvemb = (dhv_c @ m["views_emb"].t())[:, : packed.input_ch_views] if need_dvemb else None
    dfeat = q(dhv_c @ m["views_feat"].t())
    dsq = gq[:, 3]
    top = hs[-1]
    gw["feature"], gb["feature"] = top.t() @ dfeat, dfeat.sum(0)
    gw["alpha"], gb["alpha"] = top.t() @ dsq[:, None], dsq.sum(0, keepdim=True)
    dh = dfeat @ m["feature"].t() + dsq[:, None] * m["alpha"][:, 0][None, :]
    dz = q(_through_act(dh, top, arch))
    demb = None
    for i in range(D - 1, -1, -1):
        if i == skip + 1:
            gw[f"pts{i}_emb"] = emb.t() @ dz
            if need_demb:
                demb = dz @ m[f"pts{i}_emb"].t()
        gw[f"pts{i}"] = (emb if i == 0 else hs[i - 1]).t() @ dz
        gb[f"pts{i}"] = dz.sum(0)
        if i > 0:
            dh = dz @ m[f"pts{i}"].t()
            dz = q(_through_act(dh, hs[i - 1], arch))
        elif need_demb:
            demb = demb + dz @ m["pts0"].t()
    grads = (
        torch.cat([gw[n].reshape(-1) for n, _, _ in weight_layout(D, packed.W, skip, packed.cin_pad, packed.cv_pad)]),
        torch.cat([gb[n].reshape(-1) for n, _ in bias_layout(D, packed.W)]),
    )
    return grads, None if demb is None else demb[:, : packed.cin], dvemb


def render_loss_ext_plain(
    packed: PackedParams,
    pts: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor],
    gct: torch.Tensor,
    white_bkgd: bool,
) -> Tuple[RenderPassOutput, Grads, torch.Tensor]:
    """B9's arithmetic: :func:`render_loss_pts_plain` with the caller's
    per-ray cotangent ``gct`` [N, 5] (d loss / d rgb_map after the white
    background, d acc, d depth) in place of the squared error's
    (render_fused.py:428-453): ``dL/dw = sum_c g_c rgb_c + g_acc + g_depth z``
    with ``g_acc = gct[3] - sum_c g_c`` on a white background. Returns the
    recomputed forward, the packed fp32 gradients and ``dpts`` [N, S, 3]."""
    out, grads, dpts = _twin(packed, None, None, views_emb, z_vals, dists, noise, None, white_bkgd, 0.0, None, pts,
                             gct)
    return RenderPassOutput(out.rgb, out.acc, out.depth, out.weights), grads, dpts


def _twin(packed, origins, directions, views_emb, z_vals, dists, noise, target, white_bkgd, loss_scale, times=None,
          pts=None, gct=None):
    _, acc_dt = quantizer(packed)
    arch = packed.arch
    N, S = z_vals.shape
    P = N * S

    # ---- forward (as render_pass_plain), keeping each layer's output
    fwd = field_forward(packed, origins, directions, views_emb, z_vals, times, pts)
    emb, vemb, hs, feat, hv, logits = fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, fwd.logits

    # ---- composite, loss and the composite backward
    sigma = fwd.sigma
    if noise is not None:
        sigma = sigma + noise
    rgb = colour(logits, arch).reshape(N, S, 3)
    ex = torch.exp(-torch.relu(sigma) * dists)
    alpha = 1.0 - ex
    safe = torch.maximum(1.0 - alpha + 1e-10, torch.full_like(alpha, 1e-10))
    logs = torch.log(safe)
    trans = torch.exp(torch.cat([torch.zeros_like(logs[:, :1]), torch.cumsum(logs, -1)[:, :-1]], -1))
    w = alpha * trans
    acc = w.sum(-1)
    depth = (w * z_vals).sum(-1)
    rgb_map = (w[..., None] * rgb).sum(-2)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[:, None])
    if gct is None:
        err = rgb_map - target
        sqerr = (err * err).sum(-1)
        g = loss_scale * 2.0 * err  # d loss / d rgb_map
        g_acc = -g.sum(-1) if white_bkgd else torch.zeros_like(acc)
    else:  # B9: the caller's cotangent of (rgb_map, acc, depth)
        sqerr = None
        gct = gct.to(acc.dtype)
        g = gct[:, :3]
        g_acc = gct[:, 3] - g.sum(-1) if white_bkgd else gct[:, 3]
    dldw = (g[:, None, :] * rgb).sum(-1) + g_acc[:, None]
    if gct is not None:
        dldw = dldw + gct[:, 4:5] * z_vals
    dalpha = dldw * trans - _excl_suffix_sum(dldw * w) / safe
    dsig = torch.where(sigma > 0, dalpha * dists * ex, torch.zeros_like(dalpha))
    drgb = w[..., None] * g[:, None, :] * rgb * (1.0 - rgb)
    if arch == "tnerf":  # the colour ReLU's mask
        drgb = torch.where(logits.reshape(N, S, 3) > 0, drgb, torch.zeros_like(drgb))
    graw = torch.cat([drgb, dsig[..., None]], -1).reshape(P, 4)

    # ---- the field's reverse sweep (with B5's embedding cotangent)
    grads, demb, _ = field_reverse_plain(packed, emb, vemb, hs, feat, hv, graw, need_demb=pts is not None)
    dpts = None
    if pts is not None:
        x = pts.reshape(P, 3).to(acc_dt)
        dpts = encode_backward(x, demb, packed.n_freqs).reshape(N, S, 3)
    return RenderLossOutput(rgb_map, acc, depth, sqerr, w), grads, dpts


def render_loss(
    packed: PackedParams,
    origins: torch.Tensor,
    directions: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor],
    target: torch.Tensor,
    white_bkgd: bool,
    loss_scale: float,
    times: Optional[torch.Tensor] = None,
) -> Tuple[RenderLossOutput, Grads]:
    """B1 (vanilla) or B4 (T-NeRF, with per-ray ``times`` [N]) on CUDA
    tensors, the plain twin on CPU tensors."""
    N, S = z_vals.shape
    check_times(packed, times, N, "render_loss")
    if origins.device.type == "cpu":
        return render_loss_plain(
            packed, origins, directions, views_emb, z_vals, dists, noise, target, white_bkgd, loss_scale, times
        )
    dev = origins.device
    cv = views_emb.shape[-1]
    if dev.type != "cuda" or packed.W not in WIDTHS or cv != packed.input_ch_views or N * S * (packed.W + 8) >= 2**31:
        raise ValueError(f"render_loss: unsupported call (device {dev}, W {packed.W}, N {N}, S {S}, views {cv})")
    check_samples(NAME, packed, S, "render_loss")
    for x, name, shape in (
        (origins, "origins", (N, 3)), (directions, "directions", (N, 3)), (views_emb, "views_emb", (N, cv)),
        (z_vals, "z_vals", (N, S)), (dists, "dists", (N, S)), (target, "target", (N, 3)),
    ) + (((noise, "noise", (N, S)),) if noise is not None else ()) + (
        ((times, "times", (N,)),) if times is not None else ()
    ):
        _check(x, name, shape, dev)
    _check_weights(packed, dev, "render_loss")
    lib = build.load(NAME)
    tnerf = int(packed.arch == "tnerf")
    bf16 = int(packed.weights.dtype == torch.bfloat16)
    size_fn = lib.render_loss_scratch_bytes
    size_fn.restype = ctypes.c_longlong
    size_fn.argtypes = [ctypes.c_int] * 6
    nbytes = size_fn(tnerf, bf16, packed.W, packed.D, N, S)
    if nbytes < 0:
        raise ValueError(f"render_loss: unsupported width {packed.W}")

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    rgb, acc, depth, sqerr, weights = out(N, 3), out(N), out(N), out(N), out(N, S)
    gw = torch.zeros(packed.weights.numel(), dtype=torch.float32, device=dev)
    gb = torch.zeros(packed.biases.numel(), dtype=torch.float32, device=dev)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    fn = lib.render_loss_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, i, p, p, p, p, i, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, i, i] + [p] * 9
    with torch.cuda.device(dev):
        code = fn(
            tnerf, bf16, packed.W, origins.data_ptr(), directions.data_ptr(),
            times.data_ptr() if times is not None else None, views_emb.data_ptr(), cv,
            z_vals.data_ptr(), dists.data_ptr(), noise.data_ptr() if noise is not None else None, target.data_ptr(),
            packed.weights.data_ptr(), packed.biases.data_ptr(), packed.D, packed.skip, packed.n_freqs,
            int(bool(white_bkgd)), float(loss_scale), N, S,
            rgb.data_ptr(), acc.data_ptr(), depth.data_ptr(), sqerr.data_ptr(), weights.data_ptr(),
            gw.data_ptr(), gb.data_ptr(), scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "render_loss")
    launches[launch_key(NAME, packed, S)] += 1
    return RenderLossOutput(rgb, acc, depth, sqerr, weights), (gw, gb)


def render_loss_pts(
    packed: PackedParams,
    pts: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor],
    target: torch.Tensor,
    white_bkgd: bool,
    loss_scale: float,
) -> Tuple[RenderLossOutput, Grads, torch.Tensor]:
    """B5 on CUDA tensors, its twin :func:`render_loss_pts_plain` on CPU
    tensors: B1 on given positions ``pts`` [N, S, 3] of a vanilla field,
    with ``dpts`` = d(loss_scale * sum sqerr) / d pts."""
    N, S = z_vals.shape
    check_pts(packed, None, None, pts, (N, S, 3), "render_loss_pts")
    dev = z_vals.device
    if dev.type == "cpu":
        return render_loss_pts_plain(packed, pts, views_emb, z_vals, dists, noise, target, white_bkgd, loss_scale)
    cv = views_emb.shape[-1]
    if (
        dev.type != "cuda"
        or packed.W not in WIDTHS
        or cv != packed.input_ch_views
        or not 1 <= S <= 1024
        or N * S * (packed.W + 8) >= 2**31
    ):
        raise ValueError(f"render_loss_pts: unsupported call (device {dev}, W {packed.W}, N {N}, S {S}, views {cv})")
    for x, name, shape in (
        (pts, "pts", (N, S, 3)), (views_emb, "views_emb", (N, cv)), (z_vals, "z_vals", (N, S)),
        (dists, "dists", (N, S)), (target, "target", (N, 3)),
    ) + (((noise, "noise", (N, S)),) if noise is not None else ()):
        _check(x, name, shape, dev)
    _check_weights(packed, dev, "render_loss_pts")
    lib = build.load(NAME)
    bf16 = int(packed.weights.dtype == torch.bfloat16)
    size_fn = lib.render_loss_pts_scratch_bytes
    size_fn.restype = ctypes.c_longlong
    size_fn.argtypes = [ctypes.c_int] * 5
    nbytes = size_fn(bf16, packed.W, packed.D, N, S)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    rgb, acc, depth, sqerr, weights, dpts = out(N, 3), out(N), out(N), out(N), out(N, S), out(N, S, 3)
    gw = torch.zeros(packed.weights.numel(), dtype=torch.float32, device=dev)
    gb = torch.zeros(packed.biases.numel(), dtype=torch.float32, device=dev)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    fn = lib.render_loss_pts_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, p, i, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, i, i] + [p] * 10
    with torch.cuda.device(dev):
        code = fn(
            bf16, packed.W, pts.data_ptr(), views_emb.data_ptr(), cv, z_vals.data_ptr(), dists.data_ptr(),
            noise.data_ptr() if noise is not None else None, target.data_ptr(),
            packed.weights.data_ptr(), packed.biases.data_ptr(), packed.D, packed.skip, packed.n_freqs,
            int(bool(white_bkgd)), float(loss_scale), N, S,
            rgb.data_ptr(), acc.data_ptr(), depth.data_ptr(), sqerr.data_ptr(), weights.data_ptr(),
            gw.data_ptr(), gb.data_ptr(), dpts.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "render_loss_pts")
    launches[launch_key(NAME, packed, S, pts=True)] += 1
    return RenderLossOutput(rgb, acc, depth, sqerr, weights), (gw, gb), dpts


def ext_launch_key(packed: PackedParams, S: int) -> str:
    """B9's ``launches`` key: ``render_loss[ext,S=64]``, or
    ``render_loss[ext,wide,S=64]`` at the MultiRes widths."""
    return f"{NAME}[ext,wide,S={S}]" if packed.wide else f"{NAME}[ext,S={S}]"


def render_loss_ext(
    packed: PackedParams,
    pts: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor],
    gct: torch.Tensor,
    white_bkgd: bool,
) -> Tuple[RenderPassOutput, Grads, torch.Tensor]:
    """B9 on CUDA tensors, its twin :func:`render_loss_ext_plain` on CPU
    tensors: the forward of B3's pts mode recomputed, the packed fp32
    parameter gradients and ``dpts`` [N, S, 3] for the per-ray cotangent
    ``gct`` [N, 5] of (rgb_map, acc, depth)."""
    N, S = z_vals.shape
    check_pts(packed, None, None, pts, (N, S, 3), "render_loss_ext")
    dev = z_vals.device
    if dev.type == "cpu":
        return render_loss_ext_plain(packed, pts, views_emb, z_vals, dists, noise, gct, white_bkgd)
    cv = views_emb.shape[-1]
    if dev.type != "cuda" or packed.W not in WIDTHS or cv != packed.input_ch_views or N * S * (packed.W + 8) >= 2**31:
        raise ValueError(f"render_loss_ext: unsupported call (device {dev}, W {packed.W}, N {N}, S {S}, views {cv})")
    check_samples(NAME, packed, S, "render_loss_ext")
    for x, name, shape in (
        (pts, "pts", (N, S, 3)), (views_emb, "views_emb", (N, cv)), (z_vals, "z_vals", (N, S)),
        (dists, "dists", (N, S)), (gct, "gct", (N, 5)),
    ) + (((noise, "noise", (N, S)),) if noise is not None else ()):
        _check(x, name, shape, dev)
    _check_weights(packed, dev, "render_loss_ext")
    lib = build.load(NAME)
    bf16, wide = int(packed.weights.dtype == torch.bfloat16), int(packed.wide)
    size_fn = lib.render_loss_ext_scratch_bytes
    size_fn.restype = ctypes.c_longlong
    size_fn.argtypes = [ctypes.c_int] * 6
    nbytes = size_fn(bf16, wide, packed.W, packed.D, N, S)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    rgb, acc, depth, weights, dpts = out(N, 3), out(N), out(N), out(N, S), out(N, S, 3)
    gw = torch.zeros(packed.weights.numel(), dtype=torch.float32, device=dev)
    gb = torch.zeros(packed.biases.numel(), dtype=torch.float32, device=dev)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    fn = lib.render_loss_ext_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, i, p, p, i, p, p, p, p, p, p, i, i, i, i, i, i] + [p] * 9
    with torch.cuda.device(dev):
        code = fn(
            bf16, wide, packed.W, pts.data_ptr(), views_emb.data_ptr(), cv, z_vals.data_ptr(), dists.data_ptr(),
            noise.data_ptr() if noise is not None else None, gct.data_ptr(),
            packed.weights.data_ptr(), packed.biases.data_ptr(), packed.D, packed.skip, packed.n_freqs,
            int(bool(white_bkgd)), N, S,
            rgb.data_ptr(), acc.data_ptr(), depth.data_ptr(), weights.data_ptr(),
            gw.data_ptr(), gb.data_ptr(), dpts.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "render_loss_ext")
    launches[ext_launch_key(packed, S)] += 1
    return RenderPassOutput(rgb, acc, depth, weights), (gw, gb), dpts


class _RenderOutputs(torch.autograd.Function):
    """B3's pts mode forward, B9 as its backward (``make_render_outputs``,
    fused_step.py:270-321): the backward recomputes the forward from the
    saved inputs, as the Pallas VJP does, and hands back the packed
    gradients and d pts for the cotangents of rgb, acc and depth. The
    weights output, and ``views_emb``, ``z_vals``, ``dists`` and ``noise``,
    carry no gradient. On CPU tensors the twins run."""

    @staticmethod
    def forward(ctx, weights, biases, pts, packed, dtype, views_emb, z_vals, dists, noise, white_bkgd):
        run = dataclasses.replace(packed, weights=weights.detach().to(dtype).contiguous(),
                                  biases=biases.detach().contiguous())
        pts = pts.detach().contiguous()
        out = render_pass(run, None, None, views_emb, z_vals, dists, noise, white_bkgd, None, pts, ordered=True)
        ctx.run, ctx.inputs = run, (pts, views_emb, z_vals, dists, noise, white_bkgd)
        ctx.mark_non_differentiable(out.weights)
        return out.rgb, out.acc, out.depth, out.weights

    @staticmethod
    def backward(ctx, g_rgb, g_acc, g_depth, _):
        pts, views_emb, z_vals, dists, noise, white_bkgd = ctx.inputs
        n = z_vals.shape[0]

        def ct(g, *shape):
            return torch.zeros(shape, dtype=torch.float32, device=z_vals.device) if g is None else g.float()

        gct = torch.cat([ct(g_rgb, n, 3), ct(g_acc, n)[:, None], ct(g_depth, n)[:, None]], -1).contiguous()
        _, (gw, gb), dpts = render_loss_ext(ctx.run, pts, views_emb, z_vals, dists, noise, gct, white_bkgd)
        ctx.run = ctx.inputs = None
        return (gw, gb, dpts) + (None,) * 7


def render_outputs_autograd(
    packed: PackedParams,
    dtype: torch.dtype,
    pts: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor],
    white_bkgd: bool,
) -> Dict[str, torch.Tensor]:
    """A render pass as a differentiable function of the packed weights and
    the positions (``make_render_outputs``): ``{rgb, acc, depth, weights}``
    from one forward-only B3 pts-mode launch with ``dtype`` operands (on
    the SIMT body in bf16, as B9's recomputed forward: ``ordered``); the
    backward is one B9 launch. ``packed`` holds fp32 buffers packed by
    plain, differentiable torch from the modules' parameters, so autograd
    carries B9's packed gradients back to them. ``weights`` has a zero
    tangent (its consumers detach it for importance sampling), as have
    ``views_emb``, ``z_vals``, ``dists`` and ``noise``. Its plain
    counterpart is :func:`render_outputs_plain`."""
    rgb, acc, depth, weights = _RenderOutputs.apply(packed.weights, packed.biases, pts, packed, dtype, views_emb,
                                                    z_vals, dists, noise, white_bkgd)
    return {"rgb": rgb, "acc": acc, "depth": depth, "weights": weights}


def render_outputs_plain(packed, dtype, pts, views_emb, z_vals, dists, noise, white_bkgd) -> Dict[str, torch.Tensor]:
    """:func:`render_outputs_autograd`'s twin: B3's plain pts-mode forward
    under torch autograd (the weights rounded to ``dtype`` differentiably),
    its ``weights`` detached."""
    run = dataclasses.replace(packed, weights=packed.weights.to(dtype))
    out = render_pass_plain(run, None, None, views_emb, z_vals, dists, noise, white_bkgd, None, pts)
    return {"rgb": out.rgb, "acc": out.acc, "depth": out.depth, "weights": out.weights.detach()}


class _RenderLossPts(torch.autograd.Function):
    """B5 under autograd: the forward runs the kernel (or its twin), which
    forms the parameter and position gradients of ``loss_scale * sum
    sqerr`` at once; the backward scales them by the loss's cotangent (the
    per-ray outputs carry none: they feed only sampling and metrics, as in
    fused_step.py:434-450)."""

    @staticmethod
    def forward(ctx, weights, biases, pts, packed, dtype, views_emb, z_vals, dists, noise, target, white_bkgd,
                loss_scale):
        run = dataclasses.replace(packed, weights=weights.detach().to(dtype).contiguous(),
                                  biases=biases.detach().contiguous())
        out, (gw, gb), dpts = render_loss_pts(run, pts.detach().contiguous(), views_emb, z_vals, dists, noise,
                                              target, white_bkgd, loss_scale)
        ctx.save_for_backward(gw, gb, dpts)
        loss = out.sqerr.sum() * loss_scale
        ctx.mark_non_differentiable(*out)
        return (loss, *out)

    @staticmethod
    def backward(ctx, g_loss, *_):
        gw, gb, dpts = ctx.saved_tensors
        return (gw * g_loss, gb * g_loss, dpts * g_loss) + (None,) * 9


def render_loss_pts_autograd(
    packed: PackedParams,
    dtype: torch.dtype,
    pts: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor],
    target: torch.Tensor,
    white_bkgd: bool,
    loss_scale: float,
) -> Tuple[torch.Tensor, RenderLossOutput]:
    """Differentiable B5 with ``dtype`` operands: ``(loss_scale * sum
    sqerr, per-ray outputs)``. ``packed`` holds fp32 buffers packed by plain,
    differentiable torch from the modules' parameters
    (``pack_params(dict(model.named_parameters()), ...)``), so autograd
    carries the kernel's packed gradients back to them; the loss's gradient
    also reaches ``pts``."""
    loss, *out = _RenderLossPts.apply(packed.weights, packed.biases, pts, packed, dtype, views_emb, z_vals, dists,
                                      noise, target, white_bkgd, loss_scale)
    return loss, RenderLossOutput(*out)


def _unpack(grads: Grads, packed: PackedParams, trunk_key: str, heads) -> Dict[str, torch.Tensor]:
    """The packed gradient buffers -> ``{state-dict key: [out, in] grad}``:
    layer i of the trunk under ``trunk_key.format(i)``, and ``heads`` maps
    "feature", "alpha", "views", "rgb" to their keys. Padded rows are
    dropped (they carry zero)."""
    gw_buf, gb_buf = grads
    D, W, skip = packed.D, packed.W, packed.skip
    cin, cv = packed.cin, packed.input_ch_views
    mats, off = {}, 0
    for name, rows, cols in weight_layout(D, W, skip, packed.cin_pad, packed.cv_pad):
        mats[name] = gw_buf[off : off + rows * cols].view(rows, cols)
        off += rows * cols
    bias, off = {}, 0
    for name, n in bias_layout(D, W):
        bias[name] = gb_buf[off : off + n]
        off += n

    def t(x):
        return x.t().contiguous()

    out = {}
    for i in range(D):
        if i == 0:
            w = mats["pts0"][:cin]
        elif i == skip + 1:
            w = torch.cat([mats[f"pts{i}_emb"][:cin], mats[f"pts{i}"]], 0)
        else:
            w = mats[f"pts{i}"]
        key = trunk_key.format(i)
        out[f"{key}.weight"], out[f"{key}.bias"] = t(w), bias[f"pts{i}"].clone()
    mats["views"] = torch.cat([mats["views_feat"], mats["views_emb"][:cv]], 0)
    for name, key in heads.items():
        out[f"{key}.weight"], out[f"{key}.bias"] = t(mats[name]), bias[name].clone()
    return out


def unpack_grads(grads: Grads, packed: PackedParams) -> Dict[str, torch.Tensor]:
    """B1's packed gradients -> the ``VanillaNeRF`` state-dict keys."""
    return _unpack(grads, packed, "pts_linears.{}", {
        "views": "views_linears.0", "feature": "feature_linear", "alpha": "alpha_linear", "rgb": "rgb_linear",
    })


def unpack_tnerf_grads(grads: Grads, packed: PackedParams) -> Dict[str, torch.Tensor]:
    """B4's packed gradients -> the ``TNeRF`` state-dict keys (port of
    ``render_fused.py::unpack_tnerf_grads``)."""
    return _unpack(grads, packed, "layers.{}.0", {
        "alpha": "density.0", "feature": "feature.0", "views": "layer_9.0", "rgb": "color.0",
    })
