"""Kernel B10 (inverse-CDF sampling and the sorted union with the coarse
depths, ``SWNERF_PDF_MERGE=1``) through its plain twin on the CPU, against
the JAX package's ``sample_pdf_merge_pallas`` in interpret mode, and the
switch's routes: the vanilla and D-NeRF kernel steps and eval passes take
B10 under the switch and compute exactly what they computed before without
it. The CUDA kernel is held to the twin on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 34). B2's binary search, which B2 and B10 share, is held
to the linear count at the B2 wrapper's edge shapes, with the Pallas B2
kernel beside the twin (test_b2_binary_search_is_the_linear_count).

Bars: the twin against the Pallas kernel atol 1e-5 (its cdf is a matmul, the
twin's a sequential sum: B2's bar, tests/test_torch_kernels_plain.py), one
bin on rows whose cdf steps fall near the 1e-5 guard (at 1024 bins, wider:
see that test); everything else bit for bit, the searches against the linear
counts among it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.ops import sampling
from swnerf_torch.ops.kernels import launches
from swnerf_torch.ops.kernels import sample_pdf as b2
from swnerf_torch.render.core import Rays, RenderConfig, make_draws
from swnerf_torch.render.fused_eval import make_dnerf_eval_pass, make_vanilla_eval_pass
from swnerf_torch.train.fused_step import make_fused_dnerf_step, make_fused_train_step
from swnerf_torch.train.loop import init_train_state
from swnerf_tpu.ops.pallas.sample_pdf import sample_pdf_merge_pallas, sample_pdf_pallas

torch.set_num_threads(2)


def _inputs(n=300, m=64, s=128, seed=0):
    """test_b2_plain_matches_pallas_and_jnp's shape (N=300, 63 bins, 128
    samples) with the coarse depths the bins are the midpoints of: sorted
    z [N, 64], weights in [0.5, 1] (well conditioned) and uniforms, sorted
    per row as B10 takes them."""
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(2, 6, (n, m)), -1).astype(np.float32)
    bins = (0.5 * (z[:, 1:] + z[:, :-1])).astype(np.float32)
    w = rng.uniform(0.5, 1, (n, m - 2)).astype(np.float32)
    u = np.sort(rng.uniform(0, 1, (n, s)), -1).astype(np.float32)
    return z, bins, w, u


@pytest.mark.parametrize("mode", ["det", "sorted_u"])
def test_b10_twin_matches_pallas_and_b2_with_sort(mode):
    """The twin against sample_pdf_merge_pallas(interpret=True) (atol 1e-5)
    and, bit for bit, against merge_z_vals(z, sample_pdf_plain(...)): B2's
    twin and torch.sort, the path without the switch."""
    z, bins, w, u = _inputs()
    if mode == "det":
        u = np.broadcast_to(np.linspace(0, 1, 128, dtype=np.float32), u.shape).copy()
        kw = dict(det=True)
    else:
        kw = dict(u=jnp.asarray(u))
    t = [torch.from_numpy(x) for x in (z, bins, w, u)]
    got = b2.sample_pdf_merge_plain(*t)
    ref = sample_pdf_merge_pallas(jnp.asarray(z), jnp.asarray(bins), jnp.asarray(w), 128, interpret=True, **kw)
    assert got.shape == (300, 192)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert torch.equal(got, sampling.merge_z_vals(t[0], b2.sample_pdf_plain(*t[1:])))
    assert bool((got[:, 1:] >= got[:, :-1]).all())


def test_b10_wrapper_runs_the_twin_on_cpu_and_takes_any_order():
    """On CPU tensors the wrapper runs the twin and launches nothing; the
    union does not depend on the order the uniforms or depths come in."""
    z, bins, w, u = (torch.from_numpy(x) for x in _inputs(n=40))
    before = sum(launches.values())
    got = b2.sample_pdf_merge(z, bins, w, u)
    assert sum(launches.values()) == before
    perm = torch.randperm(128, generator=torch.Generator().manual_seed(0))
    assert torch.equal(got, b2.sample_pdf_merge_plain(z.flip(-1), bins, w, u[:, perm]))



SEARCH_FAMILIES = ("regular", "near_plateaus", "exact_plateaus", "small_weights")


def _search_inputs(family, n=12, m=64, seed=0):
    """n rays of one weight family, as _merge_kernel reads them: sorted z
    [n, 64], bins [n, 63] their midpoints, weights [n, 62] (regular: in
    [0.5, 1]; near plateaus: zero past column 5, so the cdf rises by 1e-5 /
    sum a column; exact plateaus: 200 in columns 0-3, zero after, so the
    rise is below half an ulp and the cdf repeats its value; small weights:
    in [0, 1e-3]), and per row the sorted uniforms 0, 1, every value of the
    row's twin cdf (63) and 63 draws: [n, 128]."""
    rng = np.random.default_rng(seed + SEARCH_FAMILIES.index(family))
    z = np.sort(rng.uniform(2, 6, (n, m)), -1).astype(np.float32)
    bins = (0.5 * (z[:, 1:] + z[:, :-1])).astype(np.float32)
    w = {"regular": lambda: rng.uniform(0.5, 1, (n, m - 2)),
         "near_plateaus": lambda: np.where(np.arange(m - 2) < 5, rng.uniform(0, 1, (n, m - 2)), 0.0),
         "exact_plateaus": lambda: np.where(np.arange(m - 2) < 4, 200.0, np.zeros((n, m - 2))),
         "small_weights": lambda: rng.uniform(0, 1e-3, (n, m - 2))}[family]().astype(np.float32)
    cdf = b2.cdf_plain(torch.from_numpy(w))
    u = np.concatenate([np.zeros((n, 1)), np.ones((n, 1)), cdf.numpy(), rng.uniform(0, 1, (n, 128 - 2 - cdf.shape[1]))], -1)
    return z, bins, w, np.sort(u, -1).astype(np.float32), cdf


@pytest.mark.parametrize("family", SEARCH_FAMILIES)
def test_b10_binary_search_is_the_linear_count(family):
    """B10's binary search (sample_pdf.count_le, the steps of
    csrc/sample_pdf.cu::count_le) on the twin's cdf (sample_pdf_plain's
    order) gives the linear count of cdf values <= u for every u: 0, 1, u
    exactly on each cdf value (on the plateaus, ties across equal values)
    and draws, on rows whose last cdf value is not 1 too. B10's co-rank
    bisection (sample_pdf.co_rank) counts, for every d, the coarse depths
    among the first d elements of the union (ties to the depth) as the
    linear ranks do, and reading the union off those counts gives the
    twin's merge bit for bit. The inputs go through
    sample_pdf_merge_pallas(interpret=True): the twin within atol 1e-5 on
    the regular and exact-plateau rows (u on the cdf values included), and
    within one bin elsewhere, where the guard denom < 1e-5 jumps a bin when
    the Pallas kernel's matmul cdf and the twin's sum differ in a last bit."""
    z, bins, w, u, cdf = _search_inputs(family)
    ut = torch.from_numpy(u)
    assert bool((cdf[:, 1:] >= cdf[:, :-1]).all())
    assert torch.equal(b2.count_le(cdf, ut), (cdf[:, None, :] <= ut[:, :, None]).sum(-1))
    if family == "exact_plateaus":
        assert bool((cdf[:, 1:] == cdf[:, :-1]).any(-1).all())
    all_cdf = torch.cat([_search_inputs(f)[4] for f in SEARCH_FAMILIES])
    assert bool((all_cdf[:, -1] > 1).any()) and bool((all_cdf[:, -1] < 1).any())

    zt, bt, wt = (torch.from_numpy(x) for x in (z, bins, w))
    smp = torch.sort(b2.sample_pdf_plain(bt, wt, ut), -1).values
    d = torch.arange(193).expand(12, 193)
    i = b2.co_rank(zt, smp, d)
    rank_z = torch.arange(64) + (smp[:, None, :] < zt[:, :, None]).sum(-1)  # z_k's place in the union
    assert torch.equal(i, (rank_z[:, None, :] < d[:, :, None]).sum(-1))
    from_z = i[:, 1:] > i[:, :-1]
    placed = torch.where(from_z, torch.gather(zt, 1, i[:, :-1].clamp(max=63)),
                         torch.gather(smp, 1, (d[:, :-1] - i[:, :-1]).clamp(max=127)))
    got = b2.sample_pdf_merge_plain(zt, bt, wt, ut)
    assert torch.equal(placed, got)

    ref = np.asarray(sample_pdf_merge_pallas(jnp.asarray(z), jnp.asarray(bins), jnp.asarray(w), 128,
                                             u=jnp.asarray(u), interpret=True))
    err = np.abs(got.numpy() - ref).max()
    assert err <= (1e-5 if family in ("regular", "exact_plateaus") else np.diff(bins, axis=-1).max()), err


def _b2_edge_inputs(m, n=8, seed=0):
    """n rays at B2's edge shapes, as sample_pdf_f32 reads them: sorted bins
    [n, m] in [2, 6] and weights [n, m-1]: rows 0-1 in [0.5, 1]; row 2
    zero past column 3 (the cdf rises by 1e-5 / sum a column); row 3 zero
    (all w = 1e-5); rows 4-5 200 up to column 3 and zero after (the rise is
    below half an ulp: the cdf repeats its value); row 6 +inf and row 7 NaN
    at the middle column. u [n, m + 16] per row: 0, 1, every value of the
    row's twin cdf (a draw where it is NaN) and 14 draws."""
    rng = np.random.default_rng(seed + m)
    bins = np.sort(rng.uniform(2, 6, (n, m)), -1).astype(np.float32)
    w = rng.uniform(0.5, 1, (n, m - 1))
    col = np.arange(m - 1)
    w[2, col > 3] = 0.0
    w[3] = 0.0
    w[4:6] = np.where(col <= 3, 200.0, 0.0)
    w[6, (m - 1) // 2] = np.inf
    w[7, (m - 1) // 2] = np.nan
    w = w.astype(np.float32)
    cdf = b2.cdf_plain(torch.from_numpy(w))
    draws = rng.uniform(0, 1, (n, m + 14)).astype(np.float32)
    on_cdf = np.where(np.isnan(cdf.numpy()), draws[:, :m], cdf.numpy())
    u = np.concatenate([np.zeros((n, 1)), np.ones((n, 1)), on_cdf, draws[:, m:]], -1).astype(np.float32)
    return bins, w, u, cdf


@pytest.mark.parametrize("m", [2, 63, 1024])
def test_b2_binary_search_is_the_linear_count(m):
    """B2's binary search (sample_pdf.count_le, the steps of
    csrc/sample_pdf.cu::count_le) on the twin's cdf gives the linear count
    of cdf values <= u at the wrapper's edge bin counts (one weight, the
    product's 63, 1024) for u = 0, 1, exactly on each cdf value and draws,
    on rows with zero weights past a column, with a +inf and with a NaN
    weight (the cdf non-decreasing up to a NaN suffix). The sample built
    from those counts by the kernel's inverse-CDF step (sample_pdf.
    inverse_cdf) is sample_pdf_plain's bit for bit, NaN where it is NaN.
    The finite rows go through sample_pdf_pallas(interpret=True): the twin
    within B2's atol 1e-5 (test_b2_plain_matches_pallas_and_jnp) on the
    rows in [0.5, 1], the zero row and the exact-plateau rows; within one
    bin on row 2, where the guard denom < 1e-5 jumps a bin when the Pallas
    kernel's matmul cdf and the twin's sum differ in a last bit (B10's
    search test above). At m = 1024 the two cdfs sum 1023 terms in
    different orders, not 62, and their difference grows with the count:
    the bar is 1e-5 * 1023 / 62 (1.2e-5 to 2.2e-5 measured on this seed),
    and two bins on row 2, whose cdfs differ by up to 4.1e-6, more than its
    plateau's step of 3.1e-6, so the counts differ by up to two."""
    bins, w, u, cdf = _b2_edge_inputs(m)
    bt, wt, ut = (torch.from_numpy(x) for x in (bins, w, u))
    assert bool((cdf[:6, 1:] >= cdf[:6, :-1]).all()) and bool(cdf[6:, -1].isnan().all())
    inds = b2.count_le(cdf, ut)
    assert torch.equal(inds, (cdf[:, None, :] <= ut[:, :, None]).sum(-1))
    got, ref = b2.inverse_cdf(cdf, bt, ut, inds), b2.sample_pdf_plain(bt, wt, ut)
    assert bool(((got.view(torch.int32) == ref.view(torch.int32)) | (got.isnan() & ref.isnan())).all())
    assert bool(got[6:].isnan().any()) and not bool(got[:6].isnan().any())

    pallas = np.asarray(sample_pdf_pallas(jnp.asarray(bins[:6]), jnp.asarray(w[:6]), u.shape[1],
                                          u=jnp.asarray(u[:6]), interpret=True))
    err = np.abs(ref[:6].numpy() - pallas).max(-1)
    bar = 1e-5 * max(1.0, (m - 1) / 62)
    assert err[[0, 1, 3, 4, 5]].max() <= bar, err
    span = 1 if m <= 63 else 2
    assert err[2] <= (bins[2, span:] - bins[2, :-span]).max(), err

def test_sorted_uniforms_are_order_statistics():
    """Exponential spacings give sorted rows in (0, 1) whose i-th entry has
    the mean of the i-th of S uniforms, i / (S + 1) (within 4 standard
    errors over 20,000 rows), from the explicit generator."""
    u = sampling.sorted_uniforms(20000, 15, torch.Generator().manual_seed(0), "cpu")
    assert u.shape == (20000, 15) and bool((u[:, 1:] >= u[:, :-1]).all()) and 0 < u.min() and u.max() < 1
    i = torch.arange(1, 16, dtype=torch.float64)
    mean, var = i / 16, i * (16 - i) / (16**2 * 17)
    assert bool(((u.double().mean(0) - mean).abs() <= 4 * (var / 20000).sqrt()).all())
    again = sampling.sorted_uniforms(20000, 15, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(u, again)


def test_sample_pdf_merge_routes_on_the_switch(monkeypatch):
    """sampling.sample_pdf_merge: without the switch B2 and torch.sort, with
    it one B10 call (its twin here); bit-equal for det and for given
    sorted uniforms; a jittered draw under the switch is sorted."""
    z, _, _, u = _inputs(n=50)
    zt = torch.from_numpy(z)
    w = torch.rand((50, 64), generator=torch.Generator().manual_seed(1))
    calls = []
    real = b2.sample_pdf_merge_plain
    monkeypatch.setattr(b2, "sample_pdf_merge_plain", lambda *a: calls.append(1) or real(*a))
    ut = torch.from_numpy(u)
    off = [sampling.sample_pdf_merge(zt, w, 128, det=True, plain=True),
           sampling.sample_pdf_merge(zt, w, 128, u=ut, plain=True)]
    assert not calls
    monkeypatch.setenv("SWNERF_PDF_MERGE", "1")
    on = [sampling.sample_pdf_merge(zt, w, 128, det=True, plain=True),
          sampling.sample_pdf_merge(zt, w, 128, u=ut, plain=True)]
    assert len(calls) == 2 and all(torch.equal(a, b) for a, b in zip(on, off))
    assert torch.equal(sampling.sample_pdf_merge(zt, w, 128, det=True), on[0])  # the CPU wrapper: the twin


def test_make_draws_sorts_the_importance_uniforms_under_the_switch(monkeypatch):
    """make_draws: without the switch the draws are those of before (t_rand,
    u from torch.rand, in render_rays' order); with it u is sorted_uniforms
    from the same generator position."""
    cfg = RenderConfig(n_samples=8, n_importance=16, perturb=1.0)
    d = make_draws(cfg, 30, torch.Generator().manual_seed(5), "cpu")
    g = torch.Generator().manual_seed(5)
    t_rand = torch.rand((30, 8), generator=g)
    assert torch.equal(d.t_rand, t_rand) and torch.equal(d.u, torch.rand((30, 16), generator=g))
    monkeypatch.setenv("SWNERF_PDF_MERGE", "1")
    d = make_draws(cfg, 30, torch.Generator().manual_seed(5), "cpu")
    g = torch.Generator().manual_seed(5)
    torch.rand((30, 8), generator=g)
    assert torch.equal(d.u, sampling.sorted_uniforms(30, 16, g, "cpu"))
    assert bool((d.u[:, 1:] >= d.u[:, :-1]).all())


def _rays(n=24, seed=0, times=False):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 4.0
    t = torch.from_numpy(rng.uniform(0, 1, (n, 1)).astype(np.float32)) if times else None
    f = torch.from_numpy
    return Rays(f(o), f(d), f(d.copy()), torch.full((n,), 2.0), torch.full((n,), 6.0), t)


SMALL = dict(netdepth=6, netwidth=128, skips=(4,), multires=4, multires_views=2)


@pytest.mark.parametrize("perturb", [0.0, 1.0], ids=["det", "jitter"])
@pytest.mark.parametrize("kind", ["vanilla", "dnerf"])
def test_kernel_steps_take_b10_and_keep_their_result(monkeypatch, kind, perturb):
    """The vanilla (make_fused_train_step) and D-NeRF (make_fused_dnerf_step)
    kernel steps on their twins, from the same state and the same draws
    (make_draws under the switch: sorted importance uniforms), with and
    without SWNERF_PDF_MERGE=1: the switch runs B10 (its twin) and every
    metric and gradient is bit-equal, since B10 is B2 + torch.sort."""
    rcfg = RenderConfig(n_samples=8, n_importance=8, perturb=perturb, raw_noise_std=1.0, white_bkgd=True)
    rays = _rays(times=kind == "dnerf")
    target = torch.rand((24, 3), generator=torch.Generator().manual_seed(2))
    monkeypatch.setenv("SWNERF_PDF_MERGE", "1")
    draws = make_draws(rcfg, 24, torch.Generator().manual_seed(3), "cpu")
    calls = []
    real = b2.sample_pdf_merge_plain
    monkeypatch.setattr(b2, "sample_pdf_merge_plain", lambda *a: calls.append(1) or real(*a))
    out = {}
    for switch in ("1", "0"):
        monkeypatch.setenv("SWNERF_PDF_MERGE", switch)
        if kind == "vanilla":
            cfg = VanillaNeRFConfig(**SMALL)
            model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
            st = init_train_state(model, None)
            m = make_fused_train_step(cfg, rcfg)(st, rays, target, draws=draws)
        else:
            cfg = DNeRFConfig(**SMALL)
            model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0), fused=False)
            st = init_train_state(model, None)
            m = make_fused_dnerf_step(cfg, rcfg, add_tv_loss=True, tv_loss_weight=0.1)(st, rays, target, 0.3,
                                                                                       draws=draws)
        out[switch] = (m, {k: p.detach().clone() for k, p in model.named_parameters()})
        if switch == "1":
            assert len(calls) == 1
    assert len(calls) == 1
    for k in out["0"][0]:
        assert torch.equal(out["1"][0][k], out["0"][0][k]), k
    for k in out["0"][1]:
        assert torch.equal(out["1"][1][k], out["0"][1][k]), k


@pytest.mark.parametrize("kind", ["vanilla", "dnerf"])
def test_eval_passes_take_b10_bit_for_bit(monkeypatch, kind):
    """The vanilla and D-NeRF eval passes (their fp32 twins) under
    SWNERF_PDF_MERGE=1 call B10 (the twin) and return bit-equal maps: det
    uniforms make z_all identical."""
    ecfg = RenderConfig(n_samples=8, n_importance=16, white_bkgd=True).eval_mode()
    rays = _rays(times=kind == "dnerf")
    if kind == "vanilla":
        cfg = VanillaNeRFConfig(**SMALL)
        model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        ep = make_vanilla_eval_pass(cfg, torch.float32)
    else:
        cfg = DNeRFConfig(**SMALL)
        model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0), fused=False)
        ep = make_dnerf_eval_pass(cfg, torch.float32)
    calls = []
    real = b2.sample_pdf_merge_plain
    monkeypatch.setattr(b2, "sample_pdf_merge_plain", lambda *a: calls.append(1) or real(*a))
    off = ep(ep.pack(model), None, rays, ecfg)
    assert not calls
    monkeypatch.setenv("SWNERF_PDF_MERGE", "1")
    on = ep(ep.pack(model), None, rays, ecfg)
    assert len(calls) == 1
    for a, b in zip(on, off):  # disp keeps the 0/0 -> NaN of the reference
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    plain = type(ep)(cfg, torch.float32, plain=True)
    for a, b in zip(plain(plain.pack(model), None, rays, ecfg), off):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
