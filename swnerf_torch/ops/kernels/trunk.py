"""Kernels B7, B7' and B8: the NeRF field trunk on embedded inputs, its
ELU T-NeRF family, and the trunk with the encode in the kernel
(``csrc/trunk.cu``, one source, a traits instantiation each), their plain
PyTorch twins, the weight packing and the autograd functions the fields run
through.

- **B7** replaces ``swnerf_tpu/ops/pallas/raymarch.py::_fwd_kernel`` /
  ``_bwd_kernel`` (``fused_trunk`` and its custom VJP ``_trunk_call``): raw
  ``[P, 4]`` (rgb logits, alpha; fp32) of a vanilla-architecture field at a
  position embedding ``emb`` ``[P, cin <= 127]`` and a view embedding
  ``vemb`` ``[P, cv <= 128]`` computed outside, the ReLU family of
  ``fused_trunk``. Its backward gives every parameter gradient and, where
  autograd asks, the embeddings' cotangents in fp32: ``demb`` carries the
  D-NeRF loss into the deformation net (``need_input_grads=True`` in
  ``models/dnerf.py:182-204``).
- **B7'** is the same bodies with ``act="elu"`` and ``rgb_relu=True``
  (``fused_tnerf``, ``raymarch.py:1094``): the T-NeRF field on
  ``[embed(x) | embed(t)]`` and ``embed(d)``, raw rgb after the colour
  head's ReLU; its backward masks the colour cotangent by the pre-clip
  output ``u > 0`` (``raymarch.py:364-368``). Weights pack in
  ``render_pass.pack_tnerf_params``'s layout (``pack_tnerf_trunk_params``,
  ``arch="tnerf"``); ``supports_tnerf_trunk`` follows ``raymarch.py::
  supports_tnerf``.
- **B8** replaces ``raymarch.py::_fwd_kernel_raw`` / ``_bwd_kernel_raw``
  (``fused_field_raw``, ``raymarch.py:956``): B7 on positions and per-row
  view directions ``[P, 3]`` (fp32), both encoded inside the kernel at the
  packed field's frequencies. Its backward gives every parameter gradient
  and, where autograd asks, d pts and d viewdirs ``[P, 3]`` in fp32 (the
  Pallas VJP returns both, ``:1003-1013``).

The forward-only wrappers (:func:`trunk`, :func:`field_raw`) run through
the PyTorch op ``swnerf::trunk`` (``torch.library.custom_op``, with a fake
that gives its shape), so a program exported by ``torch.export``
(``utils/export.py``) calls the kernels; eager calls and the op's calls
count alike in ``launches`` (at the launch).

In bf16, the forward-only launch of B7, B7' and B8 (no scratch: the mesh
sweep, ``apply_field`` without autograd, the T-NeRF render with no eval
pass) runs on the tensor cores (``csrc/trunk.cu::trunk_tc_kernel``, B3's
and B4's field product; B7' with ELU in the epilogues and its colour
lanes clipped at 0), whose sums round in another order than the SIMT
train-mode forward's: the two launches agree at the bf16 bar, not bit for
bit. B7''s bf16 train-mode forward at W=128 (the T-NeRF config's width)
runs the same product and fills the tape its backward reads; B7's, B8's,
B7''s at W=256 and every fp32 launch run the SIMT body
(``tc_rounding.py --backward b7 b7p b8``: with those forwards on the
tensor cores the gradients leave the twin's bars). Every bf16 backward
runs its reverse sweep's large products and the embeddings' cotangents
(demb, dvemb) on the tensor cores (``csrc/tc_gemm.cuh``).

The SIMT train-mode forward keeps fp32 FMAs in order, one accumulator an
output: :func:`trunk_ordered` repeats that order in torch ops for the
ReLU family in bf16, so that B7's bf16 train-mode raw equals it bit for bit
(the card's tests and ``chip_smoke.py``; nothing else calls it).

The ``pack_*`` functions lay the weights out as ``render_pass.pack_params``
does (``render_pass.weight_layout``), with both embeddings padded to 128
rows: one buffer in the operand type, biases fp32. The field family is the
packed weights' ``arch``; the twins (``trunk_plain``, ``trunk_plain_bwd``,
``field_raw_plain``, ``field_raw_plain_bwd``) follow it.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import build, launches
from swnerf_torch.ops.kernels.render_loss import encode_backward, field_reverse_plain, unpack_grads, unpack_tnerf_grads
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


def supports_field_raw(cfg) -> bool:
    """B8's configurations: B7's with the Fourier encoding (``i_embed == 0``,
    as ``fused_field_raw`` asserts), so no configuration B7 takes falls off
    B8 under ``SWNERF_FUSED_RAW=1``."""
    return supports_trunk(cfg) and cfg.i_embed == 0


def supports_tnerf_trunk(cfg) -> bool:
    """The T-NeRF shapes B7' is built for (``raymarch.py::supports_tnerf``
    with this card's widths): net_dim in (128, 256), the combined position +
    time embedding within 127 columns (room for the dW column of ones), the
    view embedding within 128, and exactly one skip inside the trunk (skips
    fire at ``i % skip_layer == 0``)."""
    return (
        cfg.net_dim in WIDTHS
        and cfg.in_feat + cfg.time_feat < CIN_PAD
        and cfg.dir_feat <= CV_PAD
        and cfg.skip_layer + 2 <= cfg.netdepth <= min(2 * cfg.skip_layer, 16)
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
    arch: str = "vanilla"  # "vanilla": the ReLU family (B7, B8); "tnerf": ELU and the colour ReLU (B7')
    cin_pad = CIN_PAD
    cv_pad = CV_PAD

    @property
    def n_freqs(self) -> Tuple[int, int]:
        """B8's (position, view) encoding frequencies, from the live widths."""
        return (self.cin - 3) // 6, (self.input_ch_views - 3) // 6

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


def pack_tnerf_trunk_params(state_dict: Mapping[str, torch.Tensor], cfg, dtype: torch.dtype = torch.bfloat16
                            ) -> PackedTrunkParams:
    """Pack a T-NeRF state dict (``layers.{i}.0``, ``density.0``,
    ``feature.0``, ``layer_9.0``, ``color.0``) for B7' in
    ``render_pass.pack_tnerf_params``'s layout with 128-row embeddings.
    Differentiable in fp32, as :func:`pack_trunk_params`."""
    if not supports_tnerf_trunk(cfg):
        raise ValueError(f"trunk does not support {cfg}")
    trunk = [layer(state_dict, f"layers.{i}.0") for i in range(cfg.netdepth)]
    heads = {k: layer(state_dict, f"{key}.0") for k, key in (
        ("feature", "feature"), ("alpha", "density"), ("views", "layer_9"), ("rgb", "color"),
    )}
    cin = cfg.in_feat + cfg.time_feat
    weights, biases = pack_buffers(trunk, heads, cfg.skip_layer, cin, CIN_PAD, CV_PAD, dtype)
    return PackedTrunkParams(weights, biases, cfg.netdepth, cfg.net_dim, cfg.skip_layer, cin, cfg.dir_feat, "tnerf")


def unpack_trunk_grads(grads: Tuple[torch.Tensor, torch.Tensor], packed: PackedTrunkParams) -> Dict[str, torch.Tensor]:
    """The packed gradients -> the state-dict keys of the packed family
    (``VanillaNeRF``'s, or ``TNeRF``'s for B7'; padded rows dropped)."""
    return (unpack_tnerf_grads if packed.arch == "tnerf" else unpack_grads)(grads, packed)


def _padded(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor):
    q, acc_dt = quantizer(packed)
    return (q(F.pad(emb.to(acc_dt), (0, CIN_PAD - emb.shape[-1]))),
            q(F.pad(vemb.to(acc_dt), (0, CV_PAD - vemb.shape[-1]))))


def trunk_plain(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor) -> torch.Tensor:
    """B7's / B7''s forward in torch ops: raw [P, 4] (rgb logits, after the
    colour ReLU for ``arch="tnerf"``, then alpha) at emb [P, cin] and vemb
    [P, cv], rounded to the operand type where the kernel rounds (the
    embeddings, each layer's output, feat, hv); float64 weights run it all in
    float64."""
    e, v = _padded(packed, emb, vemb)
    _, _, _, sigma, logits = field_mlp(packed, e, v)
    if packed.arch == "tnerf":
        logits = torch.relu(logits)
    return torch.cat([logits, sigma[:, None]], -1)


def trunk_ordered(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor) -> torch.Tensor:
    """B7's raw [P, 4] for the ReLU family in bf16, in the order of the SIMT
    train-mode forward (``csrc/trunk.cu::trunk_fwd_kernel``): each output
    one fp32 sum from +0, ``acc = acc + a * w`` over k ascending with the
    pad rows (the skip layer's embedding rows before its h rows, the view
    layer's feature rows before its view rows), then the bias, the ReLU and
    the rounding to bf16; the alpha and rgb heads as four sums over k = p,
    p + 4, ... (p = 0..3), added as ``(((s0 + s1) + s2) + s3) + b``. A
    bf16 x bf16 product is exact in fp32 (away from underflow), so each step
    rounds once, as ``fmaf`` does: the kernel's raw, bit for bit. ELU's
    expm1 may differ by an ulp between the CPU and the card, so the ELU
    family (B7') is refused."""
    if packed.arch != "vanilla" or packed.weights.dtype != torch.bfloat16:
        raise ValueError("trunk_ordered: the ReLU family in bf16 only")
    e, v = _padded(packed, emb, vemb)
    m = {k: w.float() for k, w in packed.matrices().items()}
    b = packed.bias_vectors()
    P = e.shape[0]

    def chain(acc, x, w):
        for k in range(x.shape[1]):
            acc = acc + x[:, k : k + 1] * w[k]
        return acc

    def out(acc, bias, relu):
        z = acc + bias
        return (torch.relu(z) if relu else z).to(torch.bfloat16).float()

    def head(x, w):
        parts = [torch.zeros((P, w.shape[1]), dtype=torch.float32, device=x.device) for _ in range(4)]
        for k in range(x.shape[1]):
            parts[k % 4] = parts[k % 4] + x[:, k : k + 1] * w[k]
        return ((parts[0] + parts[1]) + parts[2]) + parts[3]

    zeros = lambda n: torch.zeros((P, n), dtype=torch.float32, device=e.device)  # noqa: E731
    W = packed.W
    h = out(chain(zeros(W), e, m["pts0"]), b["pts0"], True)
    for i in range(1, packed.D):
        acc = chain(zeros(W), e, m[f"pts{i}_emb"]) if i == packed.skip + 1 else zeros(W)
        h = out(chain(acc, h, m[f"pts{i}"]), b[f"pts{i}"], True)
    feat = out(chain(zeros(W), h, m["feature"]), b["feature"], False)
    sigma = head(h, m["alpha"]) + b["alpha"]
    hv = out(chain(chain(zeros(W // 2), feat, m["views_feat"]), v, m["views_emb"]), b["views"], True)
    return torch.cat([head(hv, m["rgb"]) + b["rgb"], sigma], -1)


def trunk_plain_bwd(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor, g: torch.Tensor,
                    need_demb: bool = True, need_dvemb: bool = False):
    """B7's / B7''s backward in torch ops, from a recomputed forward: the
    packed fp32 gradients of ``sum(g * raw)`` for the cotangent g [P, 4], and
    (demb [P, cin], dvemb [P, cv]) in fp32 where asked (else None). For
    ``arch="tnerf"`` the colour cotangent is masked by the recomputed logits
    ``u > 0`` first (``raymarch.py:364-368``)."""
    _, acc_dt = quantizer(packed)
    e, v = _padded(packed, emb, vemb)
    hs, feat, hv, _, logits = field_mlp(packed, e, v)
    g = g.to(acc_dt)
    if packed.arch == "tnerf":
        g = torch.cat([torch.where(logits > 0, g[:, :3], torch.zeros_like(g[:, :3])), g[:, 3:]], -1)
    return field_reverse_plain(packed, e, v, hs, feat, hv, g, need_demb, need_dvemb)


def _embed_raw(packed: PackedTrunkParams, pts: torch.Tensor, viewdirs: torch.Tensor):
    lp, lv = packed.n_freqs
    return positional_encoding(pts, lp), positional_encoding(viewdirs, lv)


def field_raw_plain(packed: PackedTrunkParams, pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """B8's forward in torch ops: the Fourier encodes of pts [P, 3] and
    viewdirs [P, 3] (true cos, as the kernel), then :func:`trunk_plain`."""
    return trunk_plain(packed, *_embed_raw(packed, pts, viewdirs))


def field_raw_plain_bwd(packed: PackedTrunkParams, pts: torch.Tensor, viewdirs: torch.Tensor, g: torch.Tensor,
                        need_dpts: bool = True, need_dvd: bool = True):
    """B8's backward in torch ops: the packed fp32 gradients of
    ``sum(g * raw)``, and (d pts, d viewdirs) [P, 3] in fp32 where asked
    (else None): :func:`trunk_plain_bwd`'s fp32 embedding cotangents through
    ``render_loss.encode_backward`` (B5's encode backward)."""
    lp, lv = packed.n_freqs
    emb, vemb = _embed_raw(packed, pts, viewdirs)
    grads, demb, dvemb = trunk_plain_bwd(packed, emb, vemb, g, need_dpts, need_dvd)
    dpts = encode_backward(pts.to(demb.dtype), demb, lp) if need_dpts else None
    dvd = encode_backward(viewdirs.to(dvemb.dtype), dvemb, lv) if need_dvd else None
    return grads, dpts, dvd


def _lib_fn(name, restype, argtypes):
    fn = getattr(build.load(NAME), name)
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


def _bf16(packed: PackedTrunkParams) -> int:
    return int(packed.weights.dtype == torch.bfloat16)


RAW = 2  # trunk.cu's family code of B8 (B7: 0, B7': 1)


def _code(packed: PackedTrunkParams, raw: bool) -> int:
    return RAW if raw else int(packed.arch == "tnerf")


def launch_key(packed: PackedTrunkParams, raw: bool = False, bwd: bool = False) -> str:
    """The ``launches`` key of one call: ``trunk`` / ``trunk[bwd]`` (B7),
    ``trunk[tnerf]`` / ``trunk[tnerf,bwd]`` (B7'), ``trunk[raw]`` /
    ``trunk[raw,bwd]`` (B8)."""
    tags = (["raw"] if raw else ["tnerf"] if packed.arch == "tnerf" else []) + (["bwd"] if bwd else [])
    return f"{NAME}[{','.join(tags)}]" if tags else NAME


def _scratch(packed: PackedTrunkParams, P: int, dev, raw: bool = False) -> torch.Tensor:
    i = ctypes.c_int
    nbytes = _lib_fn("trunk_scratch_bytes", ctypes.c_longlong, [i, i, i, i, ctypes.c_longlong])(
        _code(packed, raw), _bf16(packed), packed.W, packed.D, P)
    if nbytes < 0:
        raise ValueError(f"trunk: unsupported width {packed.W}")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _launch_fwd(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor, scratch: Optional[torch.Tensor],
                raw: bool = False):
    """One forward launch: train mode with ``scratch``, else forward only.
    B7/B7': emb [P, cin], vemb [P, cv]; B8 (raw): pts and viewdirs [P, 3] in
    their places."""
    dev = emb.device
    P = emb.shape[0]
    shapes = ((P, 3), (P, 3)) if raw else ((P, packed.cin), (P, packed.input_ch_views))
    if dev.type != "cuda" or packed.W not in WIDTHS or (raw and packed.arch != "vanilla") or \
            tuple(emb.shape) != shapes[0] or tuple(vemb.shape) != shapes[1]:
        raise ValueError(f"trunk: unsupported call (device {dev}, W {packed.W}, arch {packed.arch}, raw {raw}, "
                         f"inputs {tuple(emb.shape)} and {tuple(vemb.shape)})")
    _check(emb, "pts" if raw else "emb", shapes[0], dev)
    _check(vemb, "viewdirs" if raw else "vemb", shapes[1], dev)
    _check_weights(packed, dev, "trunk")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    img_bytes = 0
    if scratch is None:  # the bf16 forward-only launch's weight image (csrc/trunk.cu::tc_fwd), else 0
        img_bytes = _lib_fn("trunk_image_bytes", ll, [i] * 7)(
            _code(packed, raw), _bf16(packed), packed.W, packed.D, packed.skip, packed.cin, packed.input_ch_views)
    img = torch.empty(img_bytes, dtype=torch.uint8, device=dev) if img_bytes > 0 else None
    fn = _lib_fn("trunk_fwd_launch", ctypes.c_int, [i, i, i, p, i, p, i, p, p, i, i, ll, p, p, p, ll, p])
    out = torch.empty((P, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(
            _code(packed, raw), _bf16(packed), packed.W, emb.data_ptr(), packed.cin, vemb.data_ptr(),
            packed.input_ch_views, packed.weights.data_ptr(), packed.biases.data_ptr(), packed.D, packed.skip, P,
            out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            img.data_ptr() if img is not None else None, max(img_bytes, 0),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(build.load(NAME), code, "trunk")
    launches[launch_key(packed, raw)] += 1
    return out


def _launch_bwd(packed: PackedTrunkParams, P: int, g: torch.Tensor, scratch: torch.Tensor, need_demb: bool,
                need_dvemb: bool, raw_inputs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The backward launch from a train-mode forward's scratch. B8
    (``raw_inputs`` = its pts and viewdirs): the input cotangents are d pts
    and d viewdirs [P, 3]."""
    dev = g.device
    _check(g, "g", (P, 4), dev)
    raw = raw_inputs is not None
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _lib_fn("trunk_bwd_launch", ctypes.c_int,
                 [i, i, i, p, i, i, i, i, ctypes.c_longlong, p, p, p, p, p, p, p, p, p])
    gw = torch.zeros(packed.weights.numel(), dtype=torch.float32, device=dev)
    gb = torch.zeros(packed.biases.numel(), dtype=torch.float32, device=dev)
    widths = (3, 3) if raw else (packed.cin, packed.input_ch_views)
    demb = torch.empty((P, widths[0]), dtype=torch.float32, device=dev) if need_demb else None
    dvemb = torch.empty((P, widths[1]), dtype=torch.float32, device=dev) if need_dvemb else None
    x, xv = raw_inputs if raw else (None, None)
    with torch.cuda.device(dev):
        code = fn(
            _code(packed, raw), _bf16(packed), packed.W, packed.weights.data_ptr(), packed.D, packed.skip,
            packed.cin, packed.input_ch_views, P, x.data_ptr() if raw else None, xv.data_ptr() if raw else None,
            g.data_ptr(), gw.data_ptr(), gb.data_ptr(), demb.data_ptr() if demb is not None else None,
            dvemb.data_ptr() if dvemb is not None else None, scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(build.load(NAME), code, "trunk backward")
    launches[launch_key(packed, raw, bwd=True)] += 1
    return (gw, gb), demb, dvemb


@torch.library.custom_op("swnerf::trunk", mutates_args=())
def _trunk_op(weights: torch.Tensor, biases: torch.Tensor, emb: torch.Tensor, vemb: torch.Tensor, D: int, W: int,
              skip: int, cin: int, cv: int, arch: str, raw: bool) -> torch.Tensor:
    """B7 / B7' (``arch``) or B8 (``raw``), forward only, as a PyTorch op:
    what an exported program calls (``utils/export.py``)."""
    packed = PackedTrunkParams(weights, biases, D, W, skip, cin, cv, arch)
    if emb.device.type == "cpu":
        return (field_raw_plain if raw else trunk_plain)(packed, emb, vemb)
    return _launch_fwd(packed, emb, vemb, None, raw)


@_trunk_op.register_fake
def _(weights, biases, emb, vemb, D, W, skip, cin, cv, arch, raw):
    return emb.new_empty((emb.shape[0], 4), dtype=torch.float64 if weights.dtype == torch.float64 else torch.float32)


def _call_op(packed: PackedTrunkParams, x: torch.Tensor, xv: torch.Tensor, raw: bool) -> torch.Tensor:
    return torch.ops.swnerf.trunk(packed.weights, packed.biases, x, xv, packed.D, packed.W, packed.skip, packed.cin,
                                  packed.input_ch_views, packed.arch, raw)


def trunk(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor) -> torch.Tensor:
    """B7's / B7''s forward-only launch on CUDA tensors (raw [P, 4] at emb
    [P, cin] and vemb [P, cv], fp32; in bf16 on the tensor cores), the
    plain twin on CPU tensors; through the op ``swnerf::trunk``."""
    return _call_op(packed, emb, vemb, False)


def trunk_fwd_bwd(packed: PackedTrunkParams, emb: torch.Tensor, vemb: torch.Tensor, g: torch.Tensor,
                  need_demb: bool = True, need_dvemb: bool = False):
    """raw, the packed gradients of ``sum(g * raw)``, demb and dvemb (None
    where not asked) in one go: B7's / B7''s train-mode forward and its
    backward on CUDA tensors, the twin on CPU tensors (how the card's checks
    compare the two)."""
    if emb.device.type == "cpu":
        return (trunk_plain(packed, emb, vemb), *trunk_plain_bwd(packed, emb, vemb, g, need_demb, need_dvemb))
    scratch = _scratch(packed, emb.shape[0], emb.device)
    raw = _launch_fwd(packed, emb, vemb, scratch)
    return (raw, *_launch_bwd(packed, emb.shape[0], g.contiguous(), scratch, need_demb, need_dvemb))


def field_raw(packed: PackedTrunkParams, pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """B8's forward-only launch on CUDA tensors (raw [P, 4] at pts and
    viewdirs [P, 3], fp32; in bf16 on the tensor cores), the plain twin on
    CPU tensors; through the op ``swnerf::trunk`` with ``raw``."""
    return _call_op(packed, pts, viewdirs, True)


def field_raw_fwd_bwd(packed: PackedTrunkParams, pts: torch.Tensor, viewdirs: torch.Tensor, g: torch.Tensor,
                      need_dpts: bool = True, need_dvd: bool = True):
    """raw, the packed gradients, d pts and d viewdirs (None where not
    asked): B8's train-mode forward and its backward on CUDA tensors, the
    twin on CPU tensors."""
    if pts.device.type == "cpu":
        return (field_raw_plain(packed, pts, viewdirs),
                *field_raw_plain_bwd(packed, pts, viewdirs, g, need_dpts, need_dvd))
    scratch = _scratch(packed, pts.shape[0], pts.device, raw=True)
    raw = _launch_fwd(packed, pts, viewdirs, scratch, raw=True)
    return (raw, *_launch_bwd(packed, pts.shape[0], g.contiguous(), scratch, need_dpts, need_dvd, (pts, viewdirs)))


class _Trunk(torch.autograd.Function):
    """B7, B7' or B8 (``raw``) under autograd. On the card the forward
    keeps the spilled activations (its scratch) for the backward kernel; on
    the CPU the twin's backward recomputes the forward. The parameters get
    gradients, and the inputs where autograd asks for them."""

    @staticmethod
    def forward(ctx, weights, biases, emb, vemb, packed, dtype, raw):
        run = dataclasses.replace(packed, weights=weights.detach().to(dtype).contiguous(),
                                  biases=biases.detach().contiguous())
        emb, vemb = emb.detach().contiguous(), vemb.detach().contiguous()
        ctx.run, ctx.emb, ctx.vemb, ctx.raw = run, emb, vemb, raw
        if emb.device.type == "cpu":
            ctx.scratch = None
            return (field_raw_plain if raw else trunk_plain)(run, emb, vemb)
        ctx.scratch = _scratch(run, emb.shape[0], emb.device, raw)
        return _launch_fwd(run, emb, vemb, ctx.scratch, raw)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        need_demb, need_dvemb = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        if ctx.scratch is None:
            bwd = field_raw_plain_bwd if ctx.raw else trunk_plain_bwd
            grads, demb, dvemb = bwd(ctx.run, ctx.emb, ctx.vemb, g, need_demb, need_dvemb)
        else:
            grads, demb, dvemb = _launch_bwd(ctx.run, ctx.emb.shape[0], g, ctx.scratch, need_demb, need_dvemb,
                                             (ctx.emb, ctx.vemb) if ctx.raw else None)
        ctx.scratch = None
        return grads[0], grads[1], demb, dvemb, None, None, None


def trunk_autograd(packed: PackedTrunkParams, dtype: torch.dtype, emb: torch.Tensor, vemb: torch.Tensor
                   ) -> torch.Tensor:
    """Differentiable B7 / B7' with ``dtype`` operands: raw [P, 4].
    ``packed`` holds fp32 buffers packed differentiably from the modules'
    parameters (``pack_trunk_params(params, cfg, torch.float32)``, or
    ``pack_tnerf_trunk_params``), so autograd carries the kernel's packed
    gradients back to them; emb and vemb get their cotangents when they
    require gradients."""
    return _Trunk.apply(packed.weights, packed.biases, emb, vemb, packed, dtype, False)


def field_raw_autograd(packed: PackedTrunkParams, dtype: torch.dtype, pts: torch.Tensor, viewdirs: torch.Tensor
                       ) -> torch.Tensor:
    """Differentiable B8 with ``dtype`` operands: raw [P, 4] at pts and
    viewdirs [P, 3]; they get their cotangents when they require
    gradients (``packed`` as for :func:`trunk_autograd`)."""
    return _Trunk.apply(packed.weights, packed.biases, pts, viewdirs, packed, dtype, True)


@contextlib.contextmanager
def packed_once(module: torch.nn.Module):
    """Inside the block, :func:`apply_field`'s forward-only launches on
    ``module`` pack its weights once per packing and operand type and reuse
    them: the same values and launches as packing at every call, for a run
    of many no-grad calls on weights that do not change (the mesh sweep's
    1,024 tiles, ``extract_mesh.sample_grid``)."""
    module._packed_once = {}
    try:
        yield module
    finally:
        del module._packed_once


def apply_field(module: torch.nn.Module, pack, dtype: torch.dtype, x: torch.Tensor, xv: torch.Tensor,
                raw: bool = False) -> torch.Tensor:
    """A field module's raw [P, 4] through B7 / B7' at embeddings x, xv (B8
    at positions and view directions with ``raw``), ``dtype`` operands.
    Under autograd its parameters are packed differentiably (``pack``:
    :func:`pack_trunk_params` or :func:`pack_tnerf_trunk_params`, in the
    parameters' own dtype) and the kernel's backward runs; without it, the
    forward-only launch on weights packed in ``dtype`` (once per
    :func:`packed_once` block)."""
    if torch.is_grad_enabled():
        pdt = next(module.parameters()).dtype  # fp32; float64 for a float64 run on the twins
        packed = pack(dict(module.named_parameters()), module.cfg, pdt)
        return (field_raw_autograd if raw else trunk_autograd)(packed, dtype, x, xv)
    cache = getattr(module, "_packed_once", None)
    packed = None if cache is None else cache.get((pack, dtype))
    if packed is None:
        packed = pack(dict(module.named_parameters()), module.cfg, dtype)
        if cache is not None:
            cache[(pack, dtype)] = packed
    return (field_raw if raw else trunk)(packed, x.contiguous(), xv.contiguous())
