"""The JAX package's kernel switches in the port (``utils/switches.py``):
each switch value's route, with the JAX defaults, on a card (``"cuda"``
given as a string: no card is needed to decide) and on the CPU, where the
steps and eval passes run the kernels' plain twins; and the fields'
``fused=None`` resolution on the CPU."""

import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, TNeRF, TNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.utils import switches

SWITCHES = ("SWNERF_FUSED", "SWNERF_FUSED_DTYPE", "SWNERF_FUSED_EVAL", "SWNERF_FUSED_STEP",
            "SWNERF_FUSED_INPUT_GRADS", "SWNERF_FUSED_RAW")

# (environment, device) -> (kernel_route, kernel_step, eval_pass_route, input_grads, raw_route, operand dtype)
BF16, F32 = torch.bfloat16, torch.float32
CASES = {
    "defaults-cuda": ({}, "cuda", (True, True, True, False, False, BF16)),
    "defaults-cpu": ({}, "cpu", (False, True, True, False, False, F32)),
    "fused=1-cuda": ({"SWNERF_FUSED": "1"}, "cuda", (True, True, True, False, False, BF16)),
    "fused=0-cuda": ({"SWNERF_FUSED": "0"}, "cuda", (False, False, False, False, False, BF16)),
    "fused=0-cpu": ({"SWNERF_FUSED": "0"}, "cpu", (False, False, False, False, False, F32)),
    "dtype=bf16-cuda": ({"SWNERF_FUSED_DTYPE": "bf16"}, "cuda", (True, True, True, False, False, BF16)),
    "dtype=f32-cuda": ({"SWNERF_FUSED_DTYPE": "f32"}, "cuda", (False, False, False, False, False, F32)),
    "dtype=f32-cpu": ({"SWNERF_FUSED_DTYPE": "f32"}, "cpu", (False, False, False, False, False, F32)),
    "eval=0-cuda": ({"SWNERF_FUSED_EVAL": "0"}, "cuda", (True, True, False, False, False, BF16)),
    "eval=1-cuda": ({"SWNERF_FUSED_EVAL": "1"}, "cuda", (True, True, True, False, False, BF16)),
    "eval=0-cpu": ({"SWNERF_FUSED_EVAL": "0"}, "cpu", (False, True, False, False, False, F32)),
    "step=0-cuda": ({"SWNERF_FUSED_STEP": "0"}, "cuda", (True, False, True, False, False, BF16)),
    "step=1-cuda": ({"SWNERF_FUSED_STEP": "1"}, "cuda", (True, True, True, False, False, BF16)),
    "step=0-cpu": ({"SWNERF_FUSED_STEP": "0"}, "cpu", (False, False, True, False, False, F32)),
    "input_grads=1-cuda": ({"SWNERF_FUSED_INPUT_GRADS": "1"}, "cuda", (True, True, True, True, False, BF16)),
    "input_grads=0-cuda": ({"SWNERF_FUSED_INPUT_GRADS": "0"}, "cuda", (True, True, True, False, False, BF16)),
    "raw=1-cuda": ({"SWNERF_FUSED_RAW": "1"}, "cuda", (True, True, True, False, True, BF16)),
    "raw=0-cuda": ({"SWNERF_FUSED_RAW": "0"}, "cuda", (True, True, True, False, False, BF16)),
    "fused=0,step=1-cuda": ({"SWNERF_FUSED": "0", "SWNERF_FUSED_STEP": "1"}, "cuda",
                            (False, False, False, False, False, BF16)),
    "step=0,eval=0-cuda": ({"SWNERF_FUSED_STEP": "0", "SWNERF_FUSED_EVAL": "0", "SWNERF_FUSED_RAW": "1"}, "cuda",
                           (True, False, False, False, True, BF16)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_switch_routes(case, monkeypatch):
    """Each switch value selects the JAX package's route: kernel_route (the
    fields' default, JAX ``use_fused``), the trainers' kernel step and eval
    pass, the embeddings' cotangents, B8 in the vanilla field, and the
    operand type of an explicit kernel route."""
    env, device, expected = CASES[case]
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = (switches.kernel_route(device), switches.kernel_step(device), switches.eval_pass_route(device),
           switches.input_grads(), switches.raw_route(), switches.operand_dtype(device))
    assert got == expected
    assert switches.operand_dtype(device, torch.float32) == torch.float32  # the parity mode wins
    assert switches.kernel_route(torch.device(device)) == expected[0]


@pytest.mark.parametrize("fused", [None, True, False])
def test_fields_resolve_fused_on_cpu(fused, monkeypatch):
    """fused=None on the CPU is the plain route (the twins are explicit
    only, as the JAX package's interpret mode is); fused=True takes the
    kernel route where the kernels cover the configuration."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    g = torch.Generator().manual_seed(0)
    want = bool(fused)
    v = VanillaNeRF(VanillaNeRFConfig(netdepth=4, netwidth=128, skips=(2,), multires=4, multires_views=2),
                    device="cpu", generator=g, fused=fused)
    t = TNeRF(TNeRFConfig(netdepth=4, skip_layer=2, multires=4, multires_views=2), device="cpu", generator=g,
              fused=fused)
    d = DirectTemporalNeRF(DNeRFConfig(netdepth=4, netwidth=128, skips=(2,), multires=4, multires_views=2),
                           device="cpu", generator=g, fused=fused)
    assert (v.fused, t.fused, d.fused_time, d.fused_trunk) == (want,) * 4
    narrow = VanillaNeRF(VanillaNeRFConfig(netdepth=2, netwidth=32, skips=(4,), multires=4, multires_views=2),
                         device="cpu", generator=g, fused=True)
    assert not narrow.fused  # B7 covers W in (128, 256) with a skip inside the trunk
