"""Vanilla NeRF CLI (port of ``swnerf_tpu/pipelines/run_nerf.py``).

Serving slice: ``--render_only`` renders the test views (``--render_test``)
or the spiral path from the latest checkpoint, through kernels B3 and B2 on
the card::

    python -m swnerf_torch.pipelines.run_nerf --config <cfg.txt> \\
        --render_only --render_test [--device cuda|cpu]

Training is a later slice and raises ``NotImplementedError``.
"""

from __future__ import annotations

import os

import torch

from swnerf_torch.device import resolve_device
from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.pipelines.common import load_scene, render_only
from swnerf_torch.render.core import RenderConfig
from swnerf_torch.render.fused_eval import make_vanilla_eval_pass, supports_eval_pass
from swnerf_torch.train.checkpoint import find_checkpoints, load_tar, vanilla_state_dict
from swnerf_torch.utils.config import config_parser


def create_vanilla(args, device: torch.device):
    """Models, render config and eval pass from CLI args (reference
    create_nerf, run.py:222-311), reloading the latest checkpoint.

    Returns (model, fine_model, rcfg, start, eval_pass). The eval pass runs
    bf16 kernel operands on the card and fp32 plain twins on the CPU; it is
    None for architectures B3 does not cover (the plain path renders then).
    """
    output_ch = 5 if args.N_importance > 0 else 4
    generator = torch.Generator().manual_seed(int(os.environ.get("SWNERF_SEED", "0")))

    def cfg(depth, width):
        return VanillaNeRFConfig(
            netdepth=depth, netwidth=width, skips=(4,), multires=args.multires,
            multires_views=args.multires_views, i_embed=args.i_embed, use_viewdirs=args.use_viewdirs,
            output_ch=output_ch,
        )

    mcfg = cfg(args.netdepth, args.netwidth)
    model = VanillaNeRF(mcfg, device=device, generator=generator)
    fine_model, fcfg = None, None
    if args.N_importance > 0:
        fcfg = cfg(args.netdepth_fine, args.netwidth_fine)
        fine_model = VanillaNeRF(fcfg, device=device, generator=generator)

    rcfg = RenderConfig(
        n_samples=args.N_samples, n_importance=args.N_importance, perturb=args.perturb,
        lindisp=args.lindisp, raw_noise_std=args.raw_noise_std, white_bkgd=args.white_bkgd,
        use_viewdirs=args.use_viewdirs,
    )

    start = 0
    ckpts = find_checkpoints(args.basedir, args.expname, args.ft_path)
    if ckpts and not args.no_reload:
        print("Reloading from", ckpts[-1])
        ckpt = load_tar(ckpts[-1])
        start = int(ckpt["global_step"])
        model.load_state_dict(vanilla_state_dict(ckpt["network_fn_state_dict"]))
        if fine_model is not None and ckpt.get("network_fine_state_dict"):
            fine_model.load_state_dict(vanilla_state_dict(ckpt["network_fine_state_dict"]))

    eval_pass = None
    if supports_eval_pass(mcfg, fcfg):
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        eval_pass = make_vanilla_eval_pass(mcfg, compute_dtype=dtype)
    return model, fine_model, rcfg, start, eval_pass


def main(argv=None):
    """CLI entry. Returns the render directory of ``--render_only``."""
    args = config_parser().parse_args(argv)
    device = resolve_device(args.device)
    if not args.render_only:
        raise NotImplementedError(
            "training is not ported yet: it is the next slice (ROADMAP.md Queue A item 4, "
            "kernel B1 with the eager train step); use --render_only"
        )
    scene = load_scene(args)
    os.makedirs(os.path.join(args.basedir, args.expname), exist_ok=True)
    model, fine_model, rcfg, start, eval_pass = create_vanilla(args, device)
    print("RENDER ONLY")
    savedir = render_only(model, fine_model, scene, rcfg, args, start, eval_pass=eval_pass)
    print("Done rendering", savedir)
    return savedir


if __name__ == "__main__":
    main()
