"""Kernels B3 and B4 (forward mode): the forward render pass of a vanilla
NeRF and of a T-NeRF (``csrc/render_pass.cu``), their plain PyTorch twin,
and the weight packing.

Replaces ``swnerf_tpu/ops/pallas/render_fused.py::_render_loss_kernel`` in
forward-only, from-rays mode, arch ``"vanilla"`` (B3) or ``"tnerf"`` (B4).
Inputs are per-ray origins and directions (and, for B4, the per-ray frame
times), the per-ray view embedding, and per-sample z, dist·|d| and density
noise; outputs are rgb (white-composited when asked), acc, depth and the
compositing weights, which feed B2.

B4 is B3's body with three changes (the Pallas kernel's ``act="elu"``,
``rgb_relu`` and ``build_embed_consts_xt``): the input is
``[embed(xyz) | embed(t)]``, the trunk and the view layer use ELU, and a
ReLU on the rgb logits comes before the compositor's sigmoid.

B3's pts mode also runs at the MultiRes widths (the wide family, 123 / 123
columns at level 0: ``raymarch.py:49-59`` takes inputs up to 128 columns),
which the D-NeRF eval pass of levels 0-2 and the fused phase 2
(``render_loss.render_outputs_autograd``, B9) take.

``pack_params`` and ``pack_tnerf_params`` lay the weights out for this card
rather than for the TPU's 128 lanes: one contiguous buffer in the operand
type (fp32 or bf16), each matrix ``[in, out]`` row-major, the input
embedding padded to 64 rows (96 for B4) and the view embedding to 32, or
both to 128 where those do not fit (``wide``); biases in a separate fp32
buffer. The skip layer is split into its
embedding and hidden rows, as ``swnerf_tpu/ops/pallas/raymarch.py::
pack_params`` / ``pack_tnerf_params`` do.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import build, launches

NAME = "render_pass"
CIN_PAD = 64  # padded position-embedding width (multires <= 10)
# Padded [embed(xyz) | embed(t)] width: 84 live columns at multires 10, a
# multiple of the kernel's 16-row weight tile with room for B1/B4's column
# of ones after the live columns.
CIN_PAD_T = 96
CV_PAD = 32  # padded view-embedding width (multires_views <= 4)
# The wide family (B3's pts mode and B9 at the MultiRes widths): both
# embeddings padded to 128 rows, the position's up to 127 live columns so
# that B9's train-mode body keeps its column of ones.
CIN_PAD_WIDE = 128
CV_PAD_WIDE = 128
WIDTHS = (128, 256)


def supports_config(cfg, wide: bool = False) -> bool:
    """The shapes the kernel is built for: Fourier encoding, view
    directions, one skip strictly inside the trunk, W in (128, 256), the
    embeddings within the narrow pads (64 / 32 columns). ``wide`` (B3's pts
    mode and B9, ``raymarch.py::supports_config``) also takes the MultiRes
    widths, a position embedding within 127 columns and a view embedding
    within 128, and the identity embedding (``i_embed == -1``: 3 columns
    each, the narrow pads)."""
    cin_max, cv_max = (CIN_PAD_WIDE - 1, CV_PAD_WIDE) if wide else (CIN_PAD, CV_PAD)
    return (
        cfg.use_viewdirs
        and (cfg.i_embed == 0 or (wide and cfg.i_embed == -1))
        and cfg.netwidth in WIDTHS
        and len(cfg.skips) == 1
        and 0 < cfg.skips[0] < cfg.netdepth - 1
        and cfg.input_ch <= cin_max
        and cfg.input_ch_views <= cv_max
    )


def supports_tnerf(cfg) -> bool:
    """The T-NeRF shapes B4 is built for (``raymarch.py::supports_tnerf``
    with this card's widths): Fourier encoding, W in (128, 256), the
    combined position + time embedding within ``CIN_PAD_T`` rows, the view
    embedding within ``CV_PAD``, and exactly one skip inside the trunk
    (skips fire at ``i % skip_layer == 0``)."""
    return (
        cfg.i_embed == 0
        and cfg.net_dim in WIDTHS
        and cfg.in_feat + cfg.time_feat <= CIN_PAD_T
        and cfg.dir_feat <= CV_PAD
        and cfg.skip_layer + 2 <= cfg.netdepth <= 2 * cfg.skip_layer
    )


def weight_layout(D: int, W: int, skip: int, cin_pad: int = CIN_PAD, cv_pad: int = CV_PAD
                  ) -> List[Tuple[str, int, int]]:
    """(name, rows, cols) of each packed matrix, in buffer order. The
    kernel walks the same order (csrc/render_pass.cu). ``cin_pad`` is
    ``CIN_PAD`` for a vanilla field and ``CIN_PAD_T`` for a T-NeRF; B7
    (ops/kernels/trunk.py) pads both embeddings to 128."""
    out = [("pts0", cin_pad, W)]
    for i in range(1, D):
        if i == skip + 1:
            out.append((f"pts{i}_emb", cin_pad, W))
        out.append((f"pts{i}", W, W))
    out += [
        ("feature", W, W),
        ("alpha", W, 1),
        ("views_feat", W, W // 2),
        ("views_emb", cv_pad, W // 2),
        ("rgb", W // 2, 3),
    ]
    return out


def bias_layout(D: int, W: int) -> List[Tuple[str, int]]:
    return [(f"pts{i}", W) for i in range(D)] + [
        ("feature", W), ("views", W // 2), ("rgb", 3), ("alpha", 1),
    ]


@dataclasses.dataclass(frozen=True)
class PackedParams:
    """A field's weights, packed for B3 (``arch="vanilla"``) or B4
    (``arch="tnerf"``) and their plain twin."""

    weights: torch.Tensor  # 1-D, operand dtype (float32 or bfloat16)
    biases: torch.Tensor  # 1-D float32
    D: int
    W: int
    skip: int
    n_freqs: int  # position-encoding frequencies (multires; also the time's for B4; 0: the identity)
    input_ch_views: int
    arch: str = "vanilla"
    wide: bool = False  # the MultiRes widths: both embeddings padded to 128 rows

    @property
    def cin(self) -> int:
        """Live input columns: embed(xyz), then embed(t) for a T-NeRF."""
        return 3 + 6 * self.n_freqs + (1 + 2 * self.n_freqs if self.arch == "tnerf" else 0)

    @property
    def cin_pad(self) -> int:
        if self.wide:
            return CIN_PAD_WIDE
        return CIN_PAD_T if self.arch == "tnerf" else CIN_PAD

    @property
    def cv_pad(self) -> int:
        return CV_PAD_WIDE if self.wide else CV_PAD

    def matrices(self) -> Dict[str, torch.Tensor]:
        """Views of the packed matrices, by weight_layout name."""
        out, off = {}, 0
        for name, rows, cols in weight_layout(self.D, self.W, self.skip, self.cin_pad, self.cv_pad):
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
        W, cin = self.W, self.cin
        trunk = cin * W + (self.D - 1) * W * W + cin * W  # layer 0, layers 1.., skip rows
        return trunk + W * W + W + (W + self.input_ch_views) * (W // 2) + (W // 2) * 3


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    return F.pad(w, (0, 0, 0, rows - w.shape[0]))


def pack_buffers(trunk, heads, skip: int, cin: int, cin_pad: int, cv_pad: int, dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``trunk``: ``(weight [out, in], bias)`` per layer; ``heads``: the same
    for "feature", "alpha", "views" (its input is ``[feature | view
    embedding]``) and "rgb". Returns the weights (in ``dtype``) and the fp32
    biases, packed in ``weight_layout`` / ``bias_layout`` order."""
    D, W = len(trunk), trunk[0][0].shape[0]
    mats: Dict[str, torch.Tensor] = {}
    for i, (w, _) in enumerate(trunk):
        w = w.t()  # [in, out]
        if i == 0:
            mats["pts0"] = _pad_rows(w, cin_pad)
        elif i == skip + 1:
            mats[f"pts{i}_emb"] = _pad_rows(w[:cin], cin_pad)
            mats[f"pts{i}"] = w[cin:]
        else:
            mats[f"pts{i}"] = w
    mats["feature"] = heads["feature"][0].t()
    mats["alpha"] = heads["alpha"][0].t()
    vw = heads["views"][0].t()
    mats["views_feat"] = vw[:W]
    mats["views_emb"] = _pad_rows(vw[W:], cv_pad)
    mats["rgb"] = heads["rgb"][0].t()
    flat = []
    for name, rows, cols in weight_layout(D, W, skip, cin_pad, cv_pad):
        if tuple(mats[name].shape) != (rows, cols):
            raise ValueError(f"{name}: shape {tuple(mats[name].shape)} != {(rows, cols)}")
        flat.append(mats[name].reshape(-1))
    biases = {f"pts{i}": b for i, (_, b) in enumerate(trunk)}
    biases.update({k: heads[k][1] for k in ("feature", "views", "rgb", "alpha")})
    return torch.cat(flat).to(dtype).contiguous(), torch.cat([biases[n] for n, _ in bias_layout(D, W)]).contiguous()


def _pack(trunk, heads, skip: int, cin: int, dtype: torch.dtype, **meta) -> PackedParams:
    tnerf = meta.get("arch") == "tnerf"
    wide = not tnerf and (cin > CIN_PAD or meta["input_ch_views"] > CV_PAD)  # the narrow pads do not hold them
    cin_pad = CIN_PAD_WIDE if wide else CIN_PAD_T if tnerf else CIN_PAD
    weights, biases = pack_buffers(trunk, heads, skip, cin, cin_pad, CV_PAD_WIDE if wide else CV_PAD, dtype)
    return PackedParams(weights=weights, biases=biases, D=len(trunk), W=trunk[0][0].shape[0], skip=skip, wide=wide,
                        **meta)


def layer(sd, key):
    """(weight, bias) of one layer in fp32. Not detached: packing the
    modules' own parameters (``dict(model.named_parameters())``) is
    differentiable, which the D-NeRF step relies on."""
    return sd[f"{key}.weight"].to(torch.float32), sd[f"{key}.bias"].to(torch.float32)


def pack_params(state_dict, cfg, dtype: torch.dtype = torch.bfloat16) -> PackedParams:
    """Pack a vanilla state dict (torch ``[out, in]`` layout, the ``.tar``
    keys) for B3, at the narrow pads where the embeddings fit them, else at
    the wide ones (``supports_config(cfg, wide=True)``: B3's pts mode and B9
    only). The result lies on the state dict's device."""
    if not supports_config(cfg, wide=True):
        raise ValueError(f"render_pass does not support {cfg}")
    trunk = [layer(state_dict, f"pts_linears.{i}") for i in range(cfg.netdepth)]
    heads = {k: layer(state_dict, key) for k, key in (
        ("feature", "feature_linear"), ("alpha", "alpha_linear"), ("views", "views_linears.0"), ("rgb", "rgb_linear"),
    )}
    return _pack(trunk, heads, cfg.skips[0], cfg.input_ch, dtype, n_freqs=max(cfg.nf_pts, 0),
                 input_ch_views=cfg.input_ch_views)


def pack_tnerf_params(state_dict, cfg, dtype: torch.dtype = torch.bfloat16) -> PackedParams:
    """Pack a T-NeRF state dict (the ``.tar`` keys ``layers.{i}.0``,
    ``density.0``, ``feature.0``, ``layer_9.0``, ``color.0``) for B4, as
    ``raymarch.py::pack_tnerf_params`` does: ``density`` is the alpha head,
    ``layer_9`` the view layer (split into its feature and view-embedding
    rows) and ``color`` the rgb head. The result lies on the state dict's
    device."""
    if not supports_tnerf(cfg):
        raise ValueError(f"render_pass does not support {cfg}")
    trunk = [layer(state_dict, f"layers.{i}.0") for i in range(cfg.netdepth)]
    heads = {k: layer(state_dict, f"{key}.0") for k, key in (
        ("feature", "feature"), ("alpha", "density"), ("views", "layer_9"), ("rgb", "color"),
    )}
    return _pack(trunk, heads, cfg.skip_layer, cfg.in_feat + cfg.time_feat, dtype, n_freqs=cfg.multires,
                 input_ch_views=cfg.dir_feat, arch="tnerf")


class RenderPassOutput(NamedTuple):
    rgb: torch.Tensor  # [N, 3], white-composited when asked
    acc: torch.Tensor  # [N]
    depth: torch.Tensor  # [N]
    weights: torch.Tensor  # [N, S]


def act(x: torch.Tensor, arch: str) -> torch.Tensor:
    """The trunk's and the view layer's activation: ReLU, or ELU (expm1,
    as the kernel) for a T-NeRF."""
    return F.elu(x) if arch == "tnerf" else torch.relu(x)


def colour(logits: torch.Tensor, arch: str) -> torch.Tensor:
    """Per-sample colour from the rgb logits: sigmoid, after a ReLU for a
    T-NeRF (its colour head's ReLU, then the compositor's sigmoid)."""
    return torch.sigmoid(torch.relu(logits) if arch == "tnerf" else logits)


class FieldForward(NamedTuple):
    """The plain twin's forward, per sample (rows ray-major): the rounded
    operands the kernels keep and the fp32 head outputs."""

    emb: torch.Tensor  # [P, cin_pad]
    vemb: torch.Tensor  # [P, cv_pad]
    hs: List[torch.Tensor]  # each trunk layer's output [P, W]
    feat: torch.Tensor  # [P, W]
    hv: torch.Tensor  # [P, W/2]
    sigma: torch.Tensor  # [N, S], before noise
    logits: torch.Tensor  # [P, 3]


def quantizer(packed):
    """(q, accumulation dtype) of a packed field: q rounds to the operand
    type and returns to fp32 (fp64 for float64 weights)."""
    cdt = packed.weights.dtype
    acc_dt = torch.float64 if cdt == torch.float64 else torch.float32
    return (lambda x: x.to(cdt).to(acc_dt)), acc_dt


def field_mlp(packed, emb: torch.Tensor, vemb: torch.Tensor):
    """The packed field's MLP on rounded, padded embeddings emb [P,
    cin_pad] and vemb [P, cv_pad], as the kernels run it: returns (each
    trunk layer's output, feat, hv, sigma [P] before noise, rgb logits
    [P, 3]), rounded where the kernels round."""
    q, acc_dt = quantizer(packed)
    m = {k: v.to(acc_dt) for k, v in packed.matrices().items()}
    b = packed.bias_vectors()
    hs = []
    h = emb
    for i in range(packed.D):
        z = h @ m[f"pts{i}"]
        if i == packed.skip + 1:
            z = emb @ m[f"pts{i}_emb"] + z
        h = q(act(z + b[f"pts{i}"], packed.arch))
        hs.append(h)
    feat = q(h @ m["feature"] + b["feature"])
    sigma = (h @ m["alpha"])[:, 0] + b["alpha"]
    hv = q(act(feat @ m["views_feat"] + vemb @ m["views_emb"] + b["views"], packed.arch))
    return hs, feat, hv, sigma, hv @ m["rgb"] + b["rgb"]


def field_forward(packed: PackedParams, origins, directions, views_emb, z_vals, times=None, pts=None) -> FieldForward:
    """Encode and run the packed field as the kernels do. With bf16 weights
    it rounds the embedding, each layer's output and the weights to bf16
    exactly where the kernels do; products and sums stay fp32. float64
    weights run it all in float64 (a reference for conditioning checks).
    ``pts`` [N, S, 3] (pts mode) gives the sample positions in place of
    ``origins + directions * z``."""
    q, _ = quantizer(packed)
    N, S = z_vals.shape
    P = N * S
    if pts is None:
        pts = origins[:, None, :] + directions[:, None, :] * z_vals[..., None]
    emb = positional_encoding(pts.reshape(P, 3), packed.n_freqs)
    if packed.arch == "tnerf":  # [embed(xyz) | embed(t)], t constant along the ray
        t = times.reshape(N, 1, 1).expand(N, S, 1).reshape(P, 1)
        emb = torch.cat([emb, positional_encoding(t, packed.n_freqs)], -1)
    emb = q(F.pad(emb, (0, packed.cin_pad - emb.shape[-1])))
    vemb = q(F.pad(views_emb, (0, packed.cv_pad - views_emb.shape[-1])))
    vemb = vemb[:, None, :].expand(N, S, packed.cv_pad).reshape(P, packed.cv_pad)
    hs, feat, hv, sigma, logits = field_mlp(packed, emb, vemb)
    return FieldForward(emb, vemb, hs, feat, hv, sigma.reshape(N, S), logits)


def render_pass_plain(
    packed: PackedParams,
    origins: torch.Tensor,
    directions: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
    times: Optional[torch.Tensor] = None,
    pts: Optional[torch.Tensor] = None,
) -> RenderPassOutput:
    """The same arithmetic as B3 / B4 in torch ops (see
    :func:`field_forward` for the rounding and ``pts``)."""
    N, S = z_vals.shape
    fwd = field_forward(packed, origins, directions, views_emb, z_vals, times, pts)
    sigma = fwd.sigma
    if noise is not None:
        sigma = sigma + noise
    rgb = colour(fwd.logits, packed.arch).reshape(N, S, 3)
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


def _check_weights(packed, dev, what: str) -> None:
    if (
        packed.weights.device != dev
        or packed.biases.device != dev
        or packed.weights.data_ptr() % 16
        or packed.weights.dtype not in (torch.float32, torch.bfloat16)
    ):
        raise ValueError(f"{what}: packed weights must be a 16-byte aligned fp32/bf16 buffer on the device")


def check_times(packed: PackedParams, times: Optional[torch.Tensor], n: int, what: str) -> None:
    """A T-NeRF pass needs per-ray times ``[N]``; a vanilla pass takes none."""
    if (packed.arch == "tnerf") != (times is not None):
        raise ValueError(f"{what}: arch {packed.arch!r} {'needs' if times is None else 'takes no'} times")
    if times is not None and tuple(times.shape) != (n,):
        raise ValueError(f"{what}: times must be [N] = [{n}], got {tuple(times.shape)}")


def launch_key(name: str, packed: PackedParams, S: int, pts: bool = False) -> str:
    """The ``launches`` key of one kernel call: ``render_pass[S=64]`` for
    B3, ``render_pass[pts,S=64]`` for its pts mode (``render_loss[pts,..]``:
    B5), ``render_pass[pts,wide,S=64]`` for the pts mode at the MultiRes
    widths, ``render_pass[tnerf,S=64]`` for B4."""
    if pts:
        return f"{name}[pts,wide,S={S}]" if packed.wide else f"{name}[pts,S={S}]"
    return f"{name}[S={S}]" if packed.arch == "vanilla" else f"{name}[{packed.arch},S={S}]"


def check_pts(packed: PackedParams, origins, directions, pts, shape, what: str) -> None:
    """pts mode (a vanilla field: the D-NeRF canonical pass) takes ``pts``
    ``[N, S, 3]`` and no origins or directions; the from-rays mode the
    reverse."""
    if pts is None:
        if origins is None or directions is None:
            raise ValueError(f"{what}: origins and directions are needed without pts")
        return
    if origins is not None or directions is not None or packed.arch != "vanilla":
        raise ValueError(f"{what}: pts mode takes a vanilla field and no origins or directions")
    if tuple(pts.shape) != shape:
        raise ValueError(f"{what}: pts must be {shape}, got {tuple(pts.shape)}")


@functools.lru_cache(maxsize=None)
def max_samples(name: str, tnerf: bool, bf16: bool, wide: bool, W: int) -> int:
    """The most samples per ray a launch of ``csrc/<name>.cu`` takes for this
    field family, operand type and width, as the source sizes its block's
    shared memory (``<name>_max_samples``; its launchers refuse more)."""
    fn = getattr(build.load(name), f"{name}_max_samples")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    return fn(int(tnerf), int(bf16), int(wide), W)


def check_samples(name: str, packed: PackedParams, S: int, what: str) -> None:
    """Refuse a launch whose block would not fit in shared memory."""
    limit = max_samples(name, packed.arch == "tnerf", packed.weights.dtype == torch.bfloat16, packed.wide, packed.W)
    if not 1 <= S <= limit:
        raise ValueError(f"{what}: S={S} samples per ray; this field's block fits {limit} at most")


def render_pass(
    packed: PackedParams,
    origins: torch.Tensor,
    directions: torch.Tensor,
    views_emb: torch.Tensor,
    z_vals: torch.Tensor,
    dists: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
    times: Optional[torch.Tensor] = None,
    pts: Optional[torch.Tensor] = None,
    ordered: bool = False,
) -> RenderPassOutput:
    """B3 (vanilla), B4 (T-NeRF, with per-ray ``times`` [N]) or B3's pts
    mode (``pts`` [N, S, 3] in place of origins and directions, which are
    then None; at the narrow or the wide pads) on CUDA tensors, the plain
    twin on CPU tensors. ``ordered`` (pts mode) runs bf16 on the SIMT body,
    fp32 FMAs in order, as B9's recomputed forward does, so that a training
    step's forward and B9 agree bit for bit (``render_outputs_autograd``);
    serving leaves it off and runs the tensor cores."""
    N, S = z_vals.shape
    check_times(packed, times, N, "render_pass")
    check_pts(packed, origins, directions, pts, (N, S, 3), "render_pass")
    if ordered and pts is None:
        raise ValueError("render_pass: ordered serves the pts mode only")
    dev = z_vals.device
    if dev.type == "cpu":
        return render_pass_plain(packed, origins, directions, views_emb, z_vals, dists, noise, white_bkgd, times, pts)
    cv = views_emb.shape[-1]
    if dev.type != "cuda" or packed.W not in WIDTHS or cv != packed.input_ch_views or (packed.wide and pts is None):
        raise ValueError(f"render_pass: unsupported call (device {dev}, W {packed.W}, S {S}, views {cv}, "
                         f"wide {packed.wide}: the wide pads serve the pts mode only)")
    check_samples(NAME, packed, S, "render_pass")
    rays_in = ((pts, "pts", (N, S, 3)),) if pts is not None else (
        (origins, "origins", (N, 3)), (directions, "directions", (N, 3)))
    for x, name, shape in rays_in + (
        (views_emb, "views_emb", (N, cv)), (z_vals, "z_vals", (N, S)), (dists, "dists", (N, S)),
    ) + (((noise, "noise", (N, S)),) if noise is not None else ()) + (
        ((times, "times", (N,)),) if times is not None else ()
    ):
        _check(x, name, shape, dev)
    _check_weights(packed, dev, "render_pass")
    rgb = torch.empty((N, 3), dtype=torch.float32, device=dev)
    acc = torch.empty((N,), dtype=torch.float32, device=dev)
    depth = torch.empty((N,), dtype=torch.float32, device=dev)
    weights = torch.empty((N, S), dtype=torch.float32, device=dev)
    lib = build.load(NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    bf16 = int(packed.weights.dtype == torch.bfloat16)
    size_fn = lib.render_pass_image_bytes  # the bf16 vanilla body's weight image (csrc/tc_render.cuh), else 0
    size_fn.restype = ctypes.c_longlong
    size_fn.argtypes = [i] * 6
    img_bytes = size_fn(int(packed.arch == "tnerf"), bf16, int(packed.wide), packed.W, packed.D, packed.skip)
    img = torch.empty(img_bytes, dtype=torch.uint8, device=dev) if img_bytes else None
    tail = (
        views_emb.data_ptr(), cv,
        z_vals.data_ptr(), dists.data_ptr(), noise.data_ptr() if noise is not None else None,
        packed.weights.data_ptr(), packed.biases.data_ptr(),
        packed.D, packed.skip, packed.n_freqs, int(bool(white_bkgd)), N, S,
        rgb.data_ptr(), acc.data_ptr(), depth.data_ptr(), weights.data_ptr(),
        img.data_ptr() if img is not None else None, img_bytes,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    tail_types = [p, i, p, p, p, p, p, i, i, i, i, i, i, p, p, p, p, p, ctypes.c_longlong, p]
    with torch.cuda.device(dev):
        if pts is not None:
            fn = lib.render_pass_pts_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [i, i, i, p] + tail_types[:-1] + [i, p]
            code = fn(bf16, int(packed.wide), packed.W, pts.data_ptr(), *tail[:-1], int(bool(ordered)), tail[-1])
        else:
            fn = lib.render_pass_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [i, i, i, p, p, p] + tail_types
            code = fn(
                int(packed.arch == "tnerf"), bf16, packed.W, origins.data_ptr(), directions.data_ptr(),
                times.data_ptr() if times is not None else None, *tail,
            )
    build.check(lib, code, "render_pass")
    launches[launch_key(NAME, packed, S, pts is not None)] += 1
    return RenderPassOutput(rgb, acc, depth, weights)
