"""B7's ordered twin (``ops/kernels/trunk.py::trunk_ordered``) on the CPU.

The SIMT train-mode forward of B7 keeps one fp32 accumulator an output and
adds ``fmaf(a, w, acc)`` over k in order. The twin repeats that order in
torch ops as ``acc + a * w``; the card's tests hold the kernel's bf16 raw
to it bit for bit (``tests/test_torch_cuda.py``). Here:

- the lemma that makes the two equal: a bf16 x bf16 product is exact in
  fp32 (two 8-bit significands make at most 16 bits), away from underflow,
  so ``acc + a * w`` rounds once, at the add, to the correctly rounded
  ``a * w + acc``: what ``fmaf`` returns. Checked with exact rationals;
- the twin against B7's plain twin in bf16 (``trunk_plain``: the same
  roundings, sums in the matrix product's order) and against the JAX
  package's Pallas kernel in interpret mode at bf16 (``fused_trunk``, as
  ``tests/test_torch_multires_kernels.py`` runs it), at D=4, W=128, skip 2,
  at MultiRes's level widths, 96 rows: raw within 1e-2 of the reference's
  largest value, the bf16 raw bar of the card's tests. Measured (seed 0):
  at most 2.0e-6 of the largest value against either (level 0; 8.5e-8 at
  level 1 and the identity), where 13-19% of the values differ from
  trunk_plain's: the same roundings, the sums in another order;
- that only the tests and ``chip_smoke.py`` call it.
"""

import dataclasses
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from swnerf_torch.ops.kernels import trunk as b7
from swnerf_torch.train.checkpoint import params_from_jax
from swnerf_tpu.ops.pallas.raymarch import fused_trunk
from tests.test_torch_multires_kernels import LEVELS, _canonical, _emb_inputs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _bf16(bits: int) -> np.float32:
    """The fp32 value of a bf16 bit pattern."""
    return np.array([bits << 16], np.uint32).view(np.float32)[0]


def _round32(x: Fraction) -> np.float32:
    """x rounded to the nearest fp32, ties to even (exact: the float64
    nearest to x is at most one fp32 ulp from the answer, whose neighbours
    are then compared with exact rationals)."""
    c = np.float32(float(x))
    cands = [np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))]
    best = min(abs(Fraction(float(v)) - x) for v in cands)
    near = [v for v in cands if abs(Fraction(float(v)) - x) == best]
    return min(near, key=lambda v: int(np.array([v]).view(np.uint32)[0]) & 1)


# bf16 patterns with a biased exponent in [97, 157] (about 2^-30 .. 2^30):
# every product stays a normal fp32
bf16_bits = st.builds(lambda sign, exp, man: (sign << 15) | (exp << 7) | man,
                      st.integers(0, 1), st.integers(97, 157), st.integers(0, 127))
fp32_acc = st.floats(min_value=-1e6, max_value=1e6, allow_nan=False, width=32)


@settings(max_examples=400, deadline=None)
@given(bf16_bits, bf16_bits, fp32_acc)
def test_bf16_product_is_exact_so_the_add_is_fmaf(a_bits, w_bits, acc):
    """fp32(a * w) == a * w exactly for bf16 a, w; so torch's fp32
    ``acc + a * w`` equals a single rounding of the exact a * w + acc, the
    definition of fmaf."""
    a, w, acc = _bf16(a_bits), _bf16(w_bits), np.float32(acc)
    ta, tw, tacc = (torch.tensor([v], dtype=torch.float32) for v in (a, w, acc))
    prod = (ta * tw).item()
    assert Fraction(prod) == Fraction(float(a)) * Fraction(float(w))
    got = np.float32((tacc + ta * tw).item())
    want = _round32(Fraction(float(a)) * Fraction(float(w)) + Fraction(float(acc)))
    assert got == want or (got == 0 and want == 0)


def test_round32_ties_to_even():
    """The rounding the lemma's test relies on: halfway cases go to the even
    significand, others to the nearest."""
    one = Fraction(1)
    ulp = Fraction(1, 2**23)
    assert _round32(one + ulp / 2) == np.float32(1.0)
    assert _round32(one + ulp + ulp / 2) == np.float32(1.0 + 2.0**-22)
    assert _round32(one + ulp / 2 + Fraction(1, 2**60)) == np.float32(1.0 + 2.0**-23)


@pytest.mark.parametrize("level", list(LEVELS))
def test_trunk_ordered_at_the_bf16_bar(level):
    """trunk_ordered against trunk_plain and fused_trunk(interpret=True) in
    bf16 on the same embeddings: raw within 1e-2 of the reference's largest
    value; against trunk_plain, which rounds the same values, also within
    1e-4 (measured 2.0e-6: only the sums' order differs)."""
    kw = LEVELS[level]
    cfg, emb, vemb, _ = _emb_inputs(kw)
    jcfg, params = _canonical(kw, 0)
    packed = b7.pack_trunk_params(params_from_jax(params), cfg, torch.bfloat16)
    e, v = torch.from_numpy(emb.copy()), torch.from_numpy(vemb.copy())
    got = b7.trunk_ordered(packed, e, v)
    assert got.shape == (emb.shape[0], 4) and got.dtype == torch.float32 and torch.isfinite(got).all()
    plain = b7.trunk_plain(packed, e, v)
    pallas = np.asarray(fused_trunk(params, jcfg, jnp.asarray(emb), jnp.asarray(vemb), block=64, interpret=True,
                                    compute_dtype=jnp.bfloat16), np.float32)
    for ref in (plain.numpy(), pallas):
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-2 * np.abs(ref).max(), (err, np.abs(ref).max())
    assert np.abs(got.numpy() - plain.numpy()).max() <= 1e-4 * np.abs(plain.numpy()).max()


def test_trunk_ordered_repeats_and_refuses_other_families():
    """Bit-equal on a repeat; the fp32 operand type and the ELU family are
    refused (ELU's expm1 may differ by an ulp between the CPU and the card)."""
    kw = LEVELS["level1"]
    cfg, emb, vemb, _ = _emb_inputs(kw, n=4, s=8)
    _, params = _canonical(kw, 2)
    sd = params_from_jax(params)
    e, v = torch.from_numpy(emb.copy()), torch.from_numpy(vemb.copy())
    packed = b7.pack_trunk_params(sd, cfg, torch.bfloat16)
    assert torch.equal(b7.trunk_ordered(packed, e, v), b7.trunk_ordered(packed, e, v))
    with pytest.raises(ValueError, match="ReLU family in bf16"):
        b7.trunk_ordered(b7.pack_trunk_params(sd, cfg, torch.float32), e, v)
    with pytest.raises(ValueError, match="ReLU family in bf16"):
        b7.trunk_ordered(dataclasses.replace(packed, arch="tnerf"), e, v)


def test_trunk_ordered_is_called_only_by_tests_and_chip_smoke():
    """No module of the package calls the twin: it is a yardstick of the
    kernel's order, not a route."""
    callers = [p.relative_to(ROOT).as_posix() for p in sorted((ROOT / "swnerf_torch").rglob("*.py"))
               if "trunk_ordered" in p.read_text()]
    assert callers == ["swnerf_torch/ops/kernels/trunk.py"]
    src = (ROOT / "swnerf_torch/ops/kernels/trunk.py").read_text()
    assert src.count("trunk_ordered(") == 1  # its definition
    assert "b7.trunk_ordered(" in (ROOT / "chip_smoke.py").read_text()
