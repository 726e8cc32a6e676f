"""Kernel B3: the forward render pass of a vanilla NeRF
(``csrc/render_pass.cu``), its plain PyTorch twin, and the weight packing.

Replaces ``swnerf_tpu/ops/pallas/render_fused.py::_render_loss_kernel`` in
forward-only, from-rays, vanilla mode. Inputs are per-ray origins and
directions, the per-ray view embedding, and per-sample z, dist·|d| and
density noise; outputs are rgb (white-composited when asked), acc, depth
and the compositing weights, which feed B2.

``pack_params`` lays the weights out for this card rather than for the
TPU's 128 lanes: one contiguous buffer in the operand type (fp32 or bf16),
each matrix ``[in, out]`` row-major, the position embedding padded to 64
rows and the view embedding to 32; biases in a separate fp32 buffer. The
skip layer is split into its embedding and hidden rows, as
``swnerf_tpu/ops/pallas/raymarch.py::pack_params`` does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import build, launches

NAME = "render_pass"
CIN_PAD = 64  # padded position-embedding width (multires <= 10)
CV_PAD = 32  # padded view-embedding width (multires_views <= 4)
WIDTHS = (128, 256)


def supports_config(cfg) -> bool:
    """The shapes the kernel is built for: Fourier encoding, view
    directions, one skip strictly inside the trunk, W in (128, 256)."""
    return (
        cfg.use_viewdirs
        and cfg.i_embed == 0
        and cfg.netwidth in WIDTHS
        and len(cfg.skips) == 1
        and 0 < cfg.skips[0] < cfg.netdepth - 1
        and cfg.input_ch <= CIN_PAD
        and cfg.input_ch_views <= CV_PAD
    )


def weight_layout(D: int, W: int, skip: int) -> List[Tuple[str, int, int]]:
    """(name, rows, cols) of each packed matrix, in buffer order. The
    kernel walks the same order (csrc/render_pass.cu)."""
    out = [("pts0", CIN_PAD, W)]
    for i in range(1, D):
        if i == skip + 1:
            out.append((f"pts{i}_emb", CIN_PAD, W))
        out.append((f"pts{i}", W, W))
    out += [
        ("feature", W, W),
        ("alpha", W, 1),
        ("views_feat", W, W // 2),
        ("views_emb", CV_PAD, W // 2),
        ("rgb", W // 2, 3),
    ]
    return out


def bias_layout(D: int, W: int) -> List[Tuple[str, int]]:
    return [(f"pts{i}", W) for i in range(D)] + [
        ("feature", W), ("views", W // 2), ("rgb", 3), ("alpha", 1),
    ]


@dataclasses.dataclass(frozen=True)
class PackedParams:
    """A vanilla field's weights, packed for B3 and its plain twin."""

    weights: torch.Tensor  # 1-D, operand dtype (float32 or bfloat16)
    biases: torch.Tensor  # 1-D float32
    D: int
    W: int
    skip: int
    n_freqs: int  # position-encoding frequencies (multires)
    input_ch_views: int

    def matrices(self) -> Dict[str, torch.Tensor]:
        """Views of the packed matrices, by weight_layout name."""
        out, off = {}, 0
        for name, rows, cols in weight_layout(self.D, self.W, self.skip):
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
    def macs_per_sample(self) -> int:
        """Multiply-adds per sample of the unpadded network."""
        W, cin = self.W, 3 + 6 * self.n_freqs
        trunk = cin * W + (self.D - 1) * W * W + cin * W  # layer 0, layers 1.., skip rows
        return trunk + W * W + W + (W + self.input_ch_views) * (W // 2) + (W // 2) * 3


def pack_params(state_dict, cfg, dtype: torch.dtype = torch.bfloat16) -> PackedParams:
    """Pack a vanilla state dict (torch ``[out, in]`` layout, the ``.tar``
    keys) for B3. The result lies on the state dict's device."""
    if not supports_config(cfg):
        raise ValueError(f"render_pass does not support {cfg}")
    D, W, skip = cfg.netdepth, cfg.netwidth, cfg.skips[0]
    cin, cv = cfg.input_ch, cfg.input_ch_views
    sd = {k: v.detach().to(torch.float32) for k, v in state_dict.items()}

    def pad_rows(w, rows):
        return F.pad(w, (0, 0, 0, rows - w.shape[0]))

    mats: Dict[str, torch.Tensor] = {}
    for i in range(D):
        w = sd[f"pts_linears.{i}.weight"].t()  # [in, out]
        if i == 0:
            mats["pts0"] = pad_rows(w, CIN_PAD)
        elif i == skip + 1:
            mats[f"pts{i}_emb"] = pad_rows(w[:cin], CIN_PAD)
            mats[f"pts{i}"] = w[cin:]
        else:
            mats[f"pts{i}"] = w
    mats["feature"] = sd["feature_linear.weight"].t()
    mats["alpha"] = sd["alpha_linear.weight"].t()
    vw = sd["views_linears.0.weight"].t()
    mats["views_feat"] = vw[:W]
    mats["views_emb"] = pad_rows(vw[W:], CV_PAD)
    mats["rgb"] = sd["rgb_linear.weight"].t()
    flat = []
    for name, rows, cols in weight_layout(D, W, skip):
        if tuple(mats[name].shape) != (rows, cols):
            raise ValueError(f"{name}: shape {tuple(mats[name].shape)} != {(rows, cols)}")
        flat.append(mats[name].reshape(-1))
    biases = {f"pts{i}": sd[f"pts_linears.{i}.bias"] for i in range(D)}
    biases.update(
        feature=sd["feature_linear.bias"], views=sd["views_linears.0.bias"],
        rgb=sd["rgb_linear.bias"], alpha=sd["alpha_linear.bias"],
    )
    return PackedParams(
        weights=torch.cat(flat).to(dtype).contiguous(),
        biases=torch.cat([biases[n] for n, _ in bias_layout(D, W)]).contiguous(),
        D=D, W=W, skip=skip, n_freqs=cfg.multires, input_ch_views=cv,
    )


class RenderPassOutput(NamedTuple):
    rgb: torch.Tensor  # [N, 3], white-composited when asked
    acc: torch.Tensor  # [N]
    depth: torch.Tensor  # [N]
    weights: torch.Tensor  # [N, S]


def render_pass_plain(
    packed: PackedParams,
    origins: torch.Tensor,
    directions: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
) -> RenderPassOutput:
    """The same arithmetic as B3 in torch ops. With bf16 weights it rounds
    the embedding, each layer's output and the weights to bf16 exactly
    where the kernel does; products and sums stay fp32. float64 weights run
    it all in float64 (a reference for conditioning checks)."""
    cdt = packed.weights.dtype
    acc_dt = torch.float64 if cdt == torch.float64 else torch.float32
    m = {k: v.to(acc_dt) for k, v in packed.matrices().items()}
    b = packed.bias_vectors()
    N, S = z_vals.shape
    P = N * S

    def q(x):  # round to the operand type, compute in fp32 (fp64)
        return x.to(cdt).to(acc_dt)

    pts = origins[:, None, :] + directions[:, None, :] * z_vals[..., None]
    emb = positional_encoding(pts.reshape(P, 3), packed.n_freqs)
    emb = q(F.pad(emb, (0, CIN_PAD - emb.shape[-1])))
    vemb = q(F.pad(views_emb, (0, CV_PAD - views_emb.shape[-1])))
    vemb = vemb[:, None, :].expand(N, S, CV_PAD).reshape(P, CV_PAD)

    h = emb
    for i in range(packed.D):
        z = h @ m[f"pts{i}"]
        if i == packed.skip + 1:
            z = emb @ m[f"pts{i}_emb"] + z
        h = q(torch.relu(z + b[f"pts{i}"]))
    feat = q(h @ m["feature"] + b["feature"])
    sigma = (h @ m["alpha"])[:, 0] + b["alpha"]
    hv = q(torch.relu(feat @ m["views_feat"] + vemb @ m["views_emb"] + b["views"]))
    logits = hv @ m["rgb"] + b["rgb"]

    sigma = sigma.reshape(N, S)
    if noise is not None:
        sigma = sigma + noise
    rgb = torch.sigmoid(logits).reshape(N, S, 3)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    safe = torch.maximum(1.0 - alpha + 1e-10, torch.full_like(alpha, 1e-10))
    logs = torch.log(safe)
    excl = torch.cat([torch.zeros_like(logs[:, :1]), torch.cumsum(logs, -1)[:, :-1]], -1)
    w = alpha * torch.exp(excl)
    acc = w.sum(-1)
    depth = (w * z_vals).sum(-1)
    rgb_map = (w[..., None] * rgb).sum(-2)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[:, None])
    return RenderPassOutput(rgb_map, acc, depth, w)


def _check(x: torch.Tensor, name: str, shape, device) -> None:
    if x.device != device or x.dtype != torch.float32 or not x.is_contiguous() or tuple(x.shape) != shape:
        raise ValueError(
            f"render_pass: {name} must be a contiguous float32 {shape} tensor on {device}, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}"
        )


def render_pass(
    packed: PackedParams,
    origins: torch.Tensor,
    directions: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
) -> RenderPassOutput:
    """B3 on CUDA tensors, the plain twin on CPU tensors."""
    if origins.device.type == "cpu":
        return render_pass_plain(packed, origins, directions, views_emb, z_vals, dists, noise, white_bkgd)
    dev = origins.device
    N, S = z_vals.shape
    cv = views_emb.shape[-1]
    if dev.type != "cuda" or packed.W not in WIDTHS or cv != packed.input_ch_views or not 1 <= S <= 1024:
        raise ValueError(f"render_pass: unsupported call (device {dev}, W {packed.W}, S {S}, views {cv})")
    for x, name, shape in (
        (origins, "origins", (N, 3)), (directions, "directions", (N, 3)), (views_emb, "views_emb", (N, cv)),
        (z_vals, "z_vals", (N, S)), (dists, "dists", (N, S)),
    ) + (((noise, "noise", (N, S)),) if noise is not None else ()):
        _check(x, name, shape, dev)
    if (
        packed.weights.device != dev
        or packed.biases.device != dev
        or packed.weights.data_ptr() % 16
        or packed.weights.dtype not in (torch.float32, torch.bfloat16)
    ):
        raise ValueError("render_pass: packed weights must be a 16-byte aligned fp32/bf16 buffer on the device")
    rgb = torch.empty((N, 3), dtype=torch.float32, device=dev)
    acc = torch.empty((N,), dtype=torch.float32, device=dev)
    depth = torch.empty((N,), dtype=torch.float32, device=dev)
    weights = torch.empty((N, S), dtype=torch.float32, device=dev)
    lib = build.load(NAME)
    fn = lib.render_pass_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, p, p, i, p, p, p, p, p, i, i, i, i, i, i, p, p, p, p, p]
    with torch.cuda.device(dev):
        code = fn(
            int(packed.weights.dtype == torch.bfloat16), packed.W,
            origins.data_ptr(), directions.data_ptr(), views_emb.data_ptr(), cv,
            z_vals.data_ptr(), dists.data_ptr(), noise.data_ptr() if noise is not None else None,
            packed.weights.data_ptr(), packed.biases.data_ptr(),
            packed.D, packed.skip, packed.n_freqs, int(bool(white_bkgd)), N, S,
            rgb.data_ptr(), acc.data_ptr(), depth.data_ptr(), weights.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, code, "render_pass")
    launches[f"{NAME}[S={S}]"] += 1
    return RenderPassOutput(rgb, acc, depth, weights)
