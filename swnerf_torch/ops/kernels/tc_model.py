"""A model of the bf16 tensor-core products' fp32 sums, in float64.

``wgmma`` (``csrc/tc_chunk.cuh``, ``csrc/tc_gemm.cuh``) adds its products to
the fp32 accumulator in k16 steps: each step's 16 products are summed
exactly, added to the accumulator and the result rounded to fp32. The card
rounds that step toward zero (``tc_rounding.py`` measured it against B6's
kept activations). :func:`product` models a product step by step: ``rz``
toward zero, ``rn`` to nearest, ``fold`` (each step from zero, toward zero,
then the even of it and its neighbour away from zero, added to nearest: an
unbiased fold), ``exact`` (float64 throughout).

On top of it, what the kernels would give with their products on that
model, for any device:

- :func:`sweep_field` is ``gemm_common.cuh::field_reverse`` with its
  tensor-core switch (bf16 B1's and B4's reverse sweep): the view layer's
  two dW, d feat, the feature dW, dz of the top layer and every trunk
  layer's dW and dH on the model; the rgb head, dhv, the d sigma column and
  the bias sums as the plain twin's fp32 (``render_loss.field_reverse_plain``).
  The packed weights' ``arch`` picks the family: ReLU's mask, or (T-NeRF)
  ELU's derivative from the stored output, h > 0 ? 1 : h + 1, multiplied in
  fp32 where the dH epilogue multiplies;
- :func:`sweep_trunk` is the same sweep for B7's backward with its input
  cotangent: demb = dz_{skip+1} W_emb^T stored in fp32, then + dz_0 W_0^T,
  each product on the model, their sum rounded to nearest;
- :func:`sweep_time_net` is B6's backward under the same switch (the
  3-wide head's products stay fp32: ``time_net.time_net_plain_bwd``);
- :func:`field_forward_model` is the field's forward on the model (B3's
  and B4's tensor-core chain, or any forward moved onto it), and
  :func:`composite` the render's composite and its backward in float64
  (with ``rgb_relu``, the T-NeRF's colour ReLU and its mask).

:func:`elu_tc` is the tensor-core epilogue's ELU (``tc_chunk.cuh::elu_tc``)
in fp32, the exponential exact where the card's ``__expf`` is within two
ulp.

``tc_rounding.py`` runs them on the card against the kernels;
``tests/test_torch_tc_backward.py`` runs them on the CPU against the twins.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

MODES = ("rz", "rn", "fold", "exact")


def rnd32(x: torch.Tensor, mode: str) -> torch.Tensor:
    """float64 ``x`` rounded to fp32 (``rz``: toward zero, else to nearest),
    returned as float64."""
    r = x.float()
    if mode == "rz":
        r = torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)
    return r.double()


def ulp32(x: torch.Tensor) -> torch.Tensor:
    """fp32's unit in the last place at |x| (0 at 0), as float64."""
    a = x.abs().float()
    u = torch.ldexp(torch.ones_like(a), (torch.frexp(a).exponent - 24).to(torch.int32)).double()
    return torch.where(a > 0, u, torch.zeros_like(u))


def product(X: torch.Tensor, Wm: torch.Tensor, acc: Optional[torch.Tensor] = None, mode: str = "rz") -> torch.Tensor:
    """``acc (+)= X @ Wm`` in float64 as the tensor cores sum it: K padded
    to whole 64-deep atoms (the zero rows add nothing), then one fp32
    rounding per k16 step in ``mode``."""
    X, Wm = X.double(), Wm.double()
    K = -(-X.shape[1] // 64) * 64
    X, Wm = F.pad(X, (0, K - X.shape[1])), F.pad(Wm, (0, 0, 0, K - Wm.shape[0]))
    if mode == "exact":
        return X @ Wm if acc is None else acc + X @ Wm
    for k0 in range(0, K, 16):
        g = X[:, k0:k0 + 16] @ Wm[k0:k0 + 16]
        if mode == "fold":
            t = rnd32(g, "rz")
            t = rnd32(t + torch.sign(t) * 0.5 * ulp32(t), "rn")  # the tie goes to the even neighbour
            acc = t if acc is None else rnd32(acc + t, "rn")
        else:
            acc = rnd32(g if acc is None else acc + g, mode)
    return acc


def elu_tc(z: torch.Tensor) -> torch.Tensor:
    """``tc_chunk.cuh::elu_tc`` in fp32: z for z > 0, exp(z) - 1 below -1/2,
    else the degree-7 Taylor polynomial of expm1 by Horner's rule (fp32
    fused multiply-adds, each rounded once)."""
    z = z.float()
    p = torch.full_like(z, 1.0 / 5040.0)
    for c in (1.0 / 720.0, 1.0 / 120.0, 1.0 / 24.0, 1.0 / 6.0, 0.5, 1.0):
        p = (z.double() * p.double() + torch.tensor(c, dtype=torch.float32).double()).float()
    near = z * p
    return torch.where(z > 0, z, torch.where(z < -0.5, torch.exp(z) - 1.0, near))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).double()


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float().double()


def _dw(x: torch.Tensor, dz: torch.Tensor, mode: str) -> torch.Tensor:
    """dW = X^T dZ, the reduction over the rows (sweep_dw_kernel)."""
    return product(x.t(), dz, None, mode)


def _dh(dz: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """dH = dZ W^T for the packed [in, out] matrix W (sweep_dh_kernel)."""
    return product(dz, w.t(), None, mode)


def _act(dh: torch.Tensor, h: torch.Tensor, elu: bool) -> torch.Tensor:
    """dh times the activation's derivative from its stored output h: ReLU's
    mask, or ELU's h > 0 ? 1 : h + 1 with the product rounded to fp32 (the
    dH epilogue's fp32 multiply)."""
    if elu:
        return _f32(dh * torch.where(h > 0, torch.ones_like(h), h + 1.0))
    return torch.where(h > 0, dh, torch.zeros_like(dh))


def _trunk(m, emb, hs, dz, D: int, skip: int, mode: str, gw: Dict, gb: Dict, elu: bool = False,
           need_demb: bool = False) -> Optional[torch.Tensor]:
    """trunk_reverse under TC: each layer's dW on the model, its bias as
    dz's fp32 column sum, dz of the layer below from the model's dH; with
    need_demb, the input cotangent (tc_demb: the skip layer's product stored
    in fp32, layer 0's added to it)."""
    demb = None
    for i in range(D - 1, -1, -1):
        if i == skip + 1:
            gw[f"pts{i}_emb"] = _dw(emb, dz, mode)
            if need_demb:
                demb = _dh(dz, m[f"pts{i}_emb"], mode)
        gw[f"pts{i}"] = _dw(emb if i == 0 else hs[i - 1], dz, mode)
        gb[f"pts{i}"] = _f32(dz.sum(0))
        if i > 0:
            dz = _bf16(_act(_dh(dz, m[f"pts{i}"], mode), hs[i - 1], elu))
        elif need_demb:
            demb = rnd32(demb + _dh(dz, m["pts0"], mode), "rn")
    return demb


def _sweep(packed, emb, vemb, hs: List[torch.Tensor], feat, hv, graw, mode: str, need_demb: bool):
    from swnerf_torch.ops.kernels.render_pass import bias_layout, weight_layout

    m = {k: v.double() for k, v in packed.matrices().items()}
    emb, vemb, feat, hv, graw = (x.double() for x in (emb, vemb, feat, hv, graw))
    hs = [h.double() for h in hs]
    D, skip, elu = packed.D, packed.skip, packed.arch == "tnerf"
    gq = _bf16(graw)
    gw: Dict[str, torch.Tensor] = {}
    gb: Dict[str, torch.Tensor] = {}
    dhv = _act(_f32(gq[:, :3] @ m["rgb"].t()), hv, elu)
    dhv_c = _bf16(dhv)
    gw["rgb"], gb["rgb"] = _f32(hv.t() @ gq[:, :3]), _f32(graw[:, :3].sum(0))
    gw["views_feat"], gw["views_emb"] = _dw(feat, dhv_c, mode), _dw(vemb, dhv_c, mode)
    gb["views"] = _f32(dhv.sum(0))
    dfeat = _bf16(_dh(dhv_c, m["views_feat"], mode))
    dsq = gq[:, 3]
    top = hs[-1]
    gw["feature"], gb["feature"] = _dw(top, dfeat, mode), _f32(dfeat.sum(0))
    gw["alpha"], gb["alpha"] = _f32(top.t() @ dsq[:, None]), _f32(dsq.sum(0, keepdim=True))
    dh = _f32(_dh(dfeat, m["feature"], mode) + dsq[:, None] * m["alpha"][:, 0][None, :])
    dz = _bf16(_act(dh, top, elu))
    demb = _trunk(m, emb, hs, dz, D, skip, mode, gw, gb, elu, need_demb)
    grads = (
        torch.cat([gw[n].reshape(-1) for n, _, _ in weight_layout(D, packed.W, skip, packed.cin_pad, packed.cv_pad)]),
        torch.cat([gb[n].reshape(-1) for n, _ in bias_layout(D, packed.W)]),
    )
    return grads, None if demb is None else demb[:, : packed.cin]


def sweep_field(packed, emb, vemb, hs: List[torch.Tensor], feat, hv, graw, mode: str = "rz"):
    """bf16 B1's or B4's reverse sweep with its tensor-core products on the
    model: the packed (weights, biases) gradients in float64, from the
    forward's rounded operands (``render_pass.field_forward``) and the raw
    cotangent ``graw`` [P, 4] (B4: the colour ReLU's mask already applied,
    as the composite applies it), as ``render_loss.field_reverse_plain``
    takes them."""
    return _sweep(packed, emb, vemb, hs, feat, hv, graw, mode, False)[0]


def sweep_trunk(packed, emb, vemb, hs: List[torch.Tensor], feat, hv, g, mode: str = "rz"):
    """bf16 B7's backward with its tensor-core products and the input
    cotangent on the model: ((weights, biases) gradients, demb [P, cin]) in
    float64, from the padded rounded inputs and the forward's outputs
    (``trunk._padded``, ``render_pass.field_mlp``) and the cotangent g
    [P, 4], as ``trunk.trunk_plain_bwd`` takes them."""
    return _sweep(packed, emb, vemb, hs, feat, hv, g, mode, True)


def sweep_time_net(packed, emb, hs: List[torch.Tensor], g, mode: str = "rz"):
    """bf16 B6's backward (no input cotangents) with its trunk's products on
    the model: the packed gradients of ``sum(g * dx)`` in float64, from the
    twin's forward (``time_net._forward``: the rounded embedding and each
    layer's output) and the cotangent ``g`` [P, 3]."""
    from swnerf_torch.ops.kernels.time_net import bias_layout, weight_layout

    m = {k: v.double() for k, v in packed.matrices().items()}
    emb, hs = emb.double(), [h.double() for h in hs]
    g = g.reshape(-1, 3).double()
    gq = _bf16(g)
    gw: Dict[str, torch.Tensor] = {"out": _f32(hs[-1].t() @ gq)}
    gb: Dict[str, torch.Tensor] = {"out": _f32(g.sum(0))}
    dz = _bf16(torch.where(hs[-1] > 0, _f32(gq @ m["out"].t()), torch.zeros_like(hs[-1])))
    _trunk(m, emb, hs, dz, packed.D, packed.skip, mode, gw, gb)
    return (
        torch.cat([gw[n].reshape(-1) for n, _, _ in weight_layout(packed.D, packed.W, packed.skip, packed.cin_pad)]),
        torch.cat([gb[n].reshape(-1) for n, _ in bias_layout(packed.D, packed.W)]),
    )


def field_forward_model(packed, emb, vemb, mode: str = "rz"):
    """The packed field's forward with its products on the model, rounded
    to bf16 where the kernels round: (each trunk layer's output, feat, hv,
    sigma [P], rgb logits [P, 3]), float64. ReLU, or ELU (:func:`elu_tc`,
    the tensor-core epilogue's) for the T-NeRF family."""
    m = {k: v.double() for k, v in packed.matrices().items()}
    bv = {k: v.double() for k, v in packed.bias_vectors().items()}
    emb, vemb = emb.double(), vemb.double()

    def act(x):
        return elu_tc(x).double() if packed.arch == "tnerf" else torch.relu(x)

    def fin(zz, b):
        return zz + b if mode == "exact" else rnd32(zz + b, "rn")

    hs, h = [], emb
    for i in range(packed.D):
        first = product(emb, m[f"pts{i}_emb"], None, mode) if i == packed.skip + 1 else None
        h = _bf16(act(fin(product(emb if i == 0 else h, m[f"pts{i}"], first, mode), bv[f"pts{i}"])))
        hs.append(h)
    feat = _bf16(fin(product(h, m["feature"], None, mode), bv["feature"]))
    sigma = fin(product(h, m["alpha"], None, mode), bv["alpha"])[:, 0]
    hv = _bf16(act(fin(product(vemb, m["views_emb"], product(feat, m["views_feat"], None, mode), mode),
                       bv["views"])))
    return hs, feat, hv, sigma, fin(product(hv, m["rgb"], None, mode), bv["rgb"])


def composite(sigma, logits, z, dist, noise, white: bool = True, target=None, loss_scale: float = 1.0,
              gct=None, rgb_relu: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The render's composite in float64 (``render_loss._twin``'s): rgb_map
    [N, 3] and the raw cotangent [N*S, 4] of ``loss_scale * sum(sqerr)``
    against ``target``, or (``gct`` [N, 5], B9) of the caller's cotangent
    of (rgb_map, acc, depth). ``rgb_relu`` (the T-NeRF): the colour is
    sigmoid(max(logit, 0)) and its cotangent is masked by logit > 0."""
    z, dist = z.double(), dist.double()
    N, S = z.shape
    sg = sigma.double().reshape(N, S) + (noise.double() if noise is not None else 0.0)
    lg = logits.double().reshape(N, S, 3)
    rgb = torch.sigmoid(torch.relu(lg) if rgb_relu else lg)
    ex = torch.exp(-torch.relu(sg) * dist)
    alpha = 1.0 - ex
    safe = torch.maximum(1.0 - alpha + 1e-10, torch.full_like(alpha, 1e-10))
    trans = torch.exp(torch.cat([torch.zeros_like(sg[:, :1]), torch.cumsum(torch.log(safe), -1)[:, :-1]], -1))
    w = alpha * trans
    acc = w.sum(-1)
    rgb_map = (w[..., None] * rgb).sum(-2) + ((1.0 - acc)[:, None] if white else 0.0)
    if gct is None:
        g = loss_scale * 2.0 * (rgb_map - target.double())
        dldw = (g[:, None, :] * rgb).sum(-1) + ((-g.sum(-1))[:, None] if white else 0.0)
    else:
        gct = gct.double()
        g = gct[:, :3]
        g_acc = gct[:, 3] - g.sum(-1) if white else gct[:, 3]
        dldw = (g[:, None, :] * rgb).sum(-1) + g_acc[:, None] + gct[:, 4:5] * z
    excl = torch.flip(torch.cumsum(torch.flip(dldw * w, [-1]), -1), [-1]) - dldw * w
    dsig = torch.where(sg > 0, (dldw * trans - excl / safe) * dist * ex, torch.zeros_like(sg))
    drgb = w[..., None] * g[:, None, :] * rgb * (1.0 - rgb)
    if rgb_relu:
        drgb = torch.where(lg > 0, drgb, torch.zeros_like(drgb))
    graw = torch.cat([drgb, dsig[..., None]], -1).reshape(N * S, 4)
    return rgb_map, graw
