"""T-NeRF CLI (port of ``swnerf_tpu/pipelines/run_tnerf.py``): one
time-conditioned field, no fine pass.

Training (the default) and ``--render_only`` serving::

    python -m swnerf_torch.pipelines.run_tnerf --config <cfg.txt> [--device cuda|cpu]
    python -m swnerf_torch.pipelines.run_tnerf --config <cfg.txt> --render_only --render_test

The dnerf flag set (``config_parser_dnerf``), the dynamic Blender loader,
``net_dim`` 128 and skip 4 whatever ``--netwidth`` says, and
``N_importance`` forced to 0 (reference run_tnerf.py:264-280,329).
Training resumes from the latest ``.tar`` or native ``.msgpack`` of the
experiment (or ``--ft_path``) with its Adam state, runs one train step per
iteration (the kernel step on B4 where ``supports_fused_tnerf_step`` and
``utils/switches.py::kernel_step`` hold, else the eager autograd step, whose
field runs B7' on a card), saves ``{iter:06d}.tar`` (and/or the native
``.msgpack``, ``SWNERF_CKPT_FORMAT``) every ``--i_weights``, renders the
test views at their frame times every ``--i_testset`` and the render path
as PNG frames and rgb / disp videos every ``--i_video``, and prints and logs
to ``metrics.jsonl`` (and TensorBoard where tensorboardX imports) every
``--i_print``. ``SWNERF_MAX_ITERS`` caps the iteration count (testing).
Serving renders the test views (or the render path) at their frame times
through B4 and writes PNG frames, the video and metrics.json. Steps run
``SWNERF_STEPS_PER_DISPATCH`` at a time (20 on a card: CUDA-graph replays,
``pipelines/common.py::KStepRoute``), through ``run_dnerf``'s
``make_dnerf_scan_step`` as in the JAX package. Launched as N processes the
ranks share each step's rays and each frame's chunks (``parallel/``, as
``run_nerf``); under ``SWNERF_TENSOR_PARALLEL=k`` the field is cut into
column and row shards over a ``(rays, model)`` grid of ranks
(``parallel/tensor.py``) and trains through the eager step, and the saves
and renders gather it, as ``run_nerf``'s.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Dict, Optional, Union

import numpy as np
import torch

from swnerf_torch.device import resolve_device
from swnerf_torch.models import TNeRF, TNeRFConfig
from swnerf_torch.ops.kernels.render_pass import supports_tnerf
from swnerf_torch.parallel import (
    check_dispatch,
    checkpoint_state,
    field_route,
    initialize_from_env,
    parallel_setup,
    render_fields,
)
from swnerf_torch.pipelines.common import (
    DeadInitWatchdog,
    ImageSampler,
    StepTimer,
    auto_reseed_loop,
    chunk_until_event,
    load_scene,
    render_only,
    render_path,
    seed_value,
    steps_per_dispatch,
)
from swnerf_torch.pipelines.run_dnerf import make_dnerf_scan_step
from swnerf_torch.render.core import RenderConfig
from swnerf_torch.render.fused_eval import make_tnerf_eval_pass
from swnerf_torch.train.checkpoint import (
    native_state,
    restore_native_state,
    resume_checkpoint,
    save_checkpoint,
    tnerf_state_dict,
)
from swnerf_torch.train.fused_step import make_fused_tnerf_step, supports_fused_tnerf_step
from swnerf_torch.train.loop import TrainState, init_train_state, make_train_step
from swnerf_torch.utils.config import config_parser_dnerf
from swnerf_torch.utils.switches import eval_pass_route, kernel_step
from swnerf_torch.utils.logging import ExperimentLogger, snapshot_args
from swnerf_torch.utils.media import write_video


def create_tnerf(args, device: torch.device, fused: Optional[bool] = None):
    """The field, train state, render config and eval pass from CLI args
    (reference run_tnerf.py:264-280), resuming from the latest checkpoint:
    weights, Adam state and ``start = global_step``. ``fused``: the field's
    kernel route (None: where the card and the switches take it; False
    under tensor parallelism).

    Returns (state, rcfg, eval_pass, mcfg). The eval pass runs B4 with bf16
    operands on the card and its fp32 plain twin on the CPU; it is None for
    architectures B4 does not cover and under ``SWNERF_FUSED_EVAL=0``
    (``switches.eval_pass_route``): ``render_image`` then applies the field,
    through B7' on a card.
    """
    mcfg = TNeRFConfig(
        netdepth=args.netdepth, net_dim=128, skip_layer=4, multires=args.multires,
        multires_views=args.multires_views, i_embed=args.i_embed,
    )
    model = TNeRF(mcfg, device=device, generator=torch.Generator().manual_seed(seed_value()), fused=fused)
    rcfg = RenderConfig(
        n_samples=args.N_samples, n_importance=0, perturb=args.perturb, lindisp=args.lindisp,
        raw_noise_std=args.raw_noise_std, white_bkgd=args.white_bkgd, use_viewdirs=True,
    )
    state = init_train_state(model, None, args.lrate, args.lrate_decay, graphs=True)

    def restore_tar(ckpt):
        state.set_step(int(ckpt["global_step"]))
        model.load_state_dict(tnerf_state_dict(ckpt["network_fn_state_dict"]))
        if ckpt.get("optimizer_state_dict"):
            state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])

    resume_checkpoint(args.basedir, args.expname, args.ft_path, args.no_reload, lambda: native_state(state),
                      partial(restore_native_state, state), restore_tar)

    eval_pass = None
    if supports_tnerf(mcfg) and eval_pass_route(device):
        eval_pass = make_tnerf_eval_pass(mcfg, torch.bfloat16 if device.type == "cuda" else torch.float32)
    return state, rcfg, eval_pass, mcfg


def save_tnerf_ckpt(args, state: TrainState, i: int) -> str:
    """``{i:06d}.tar`` with the T-NeRF schema (run_tnerf.py:719-728; the
    optimizer's learning rate is the schedule's at ``i``, as the JAX package
    writes it) and/or the native ``{i:06d}.msgpack``, as
    ``SWNERF_CKPT_FORMAT`` selects. Returns the ``.tar``'s path."""
    def tar_payload():
        opt = state.optimizer.state_dict()
        for group in opt["param_groups"]:
            group["lr"] = state.schedule(i)
        return {"global_step": i, "network_fn_state_dict": state.coarse.state_dict(), "optimizer_state_dict": opt}

    return save_checkpoint(args.basedir, args.expname, i, tar_payload, lambda: native_state(state))


def train(argv=None):
    """Product entry; with ``SWNERF_AUTO_RESEED=N`` a watchdog-confirmed
    dead-density init restarts training (at most N times) with a new seed."""
    return auto_reseed_loop(_train_impl, argv)


main = train


def _train_impl(argv=None) -> Union[str, Dict]:
    """The CLI: ``--render_only`` renders and returns the directory of the
    frames; training returns ``{"metrics": the last step's metrics,
    "step_ms": {iteration: device ms}}`` (CUDA events after every step)."""
    args = config_parser_dnerf().parse_args(argv)
    if args.dataset_type != "blender":
        raise ValueError(f"Unknown dataset type {args.dataset_type!r} (tnerf supports blender)")
    initialize_from_env(args.device)  # before the first device query; a no-op single-process
    device = resolve_device(args.device)
    args.dataset_type = "blender_dnerf"
    scene = load_scene(args)
    args.dataset_type = "blender"
    os.makedirs(os.path.join(args.basedir, args.expname), exist_ok=True)
    snapshot_args(args.basedir, args.expname, args, args.config)
    state, rcfg, eval_pass, mcfg = create_tnerf(args, device, fused=field_route(args.render_only))
    # a mesh: the field cut, the eager step
    mesh, group, render_group = parallel_setup(state, 0 if args.render_only else args.N_rand, args.render_only)
    start = state.step

    if args.render_only:
        print("RENDER ONLY")
        savedir = render_only(state.coarse, None, scene, rcfg, args, start, eval_pass=eval_pass, group=render_group)
        print("Done rendering", savedir)
        return savedir

    logger = ExperimentLogger(args.basedir, args.expname)
    sampler = ImageSampler(scene, args.N_rand, args.precrop_iters, args.precrop_frac,
                           precrop_iters_time=args.precrop_iters_time)
    if mesh is None and supports_fused_tnerf_step(mcfg, rcfg) and kernel_step(device):
        train_step = make_fused_tnerf_step(mcfg, rcfg, group=group)
        print("Using the kernel T-NeRF train step (B4 render-loss)")
    else:
        train_step = make_train_step(rcfg, group=group)
        print("Using the eager autograd train step")
    scan_fn = make_dnerf_scan_step(train_step, rcfg, scene, pass_neighbor=False)
    images_dev = torch.as_tensor(scene.images, device=device)
    poses_dev = torch.as_tensor(scene.poses[:, :3, :4], device=device)
    times_dev = torch.as_tensor(scene.times, device=device)
    generator = torch.Generator(device=device).manual_seed(seed_value(1))
    k_disp = steps_per_dispatch(device)
    check_dispatch(group, device, k_disp)

    n_iters = int(os.environ.get("SWNERF_MAX_ITERS", args.N_iter + 1))
    samples_per_step = args.N_rand * rcfg.n_samples
    cadences = (args.i_weights, args.i_print, args.i_video, args.i_testset)
    print("Begin")
    print("TRAIN views are", scene.i_train)
    print("TEST views are", scene.i_test)
    # Auto-reseed restarts only before the first checkpoint, never on a resume.
    watchdog = DeadInitWatchdog(args.i_print, restart_until=args.i_weights if start == 0 else 0)
    timer = StepTimer(device, start)

    metrics = {}
    i = start + 1
    while i < n_iters:
        k = chunk_until_event(i, n_iters, k_disp, cadences)
        picks = [sampler.next(i + j) for j in range(k)]
        img_i_k = np.asarray([p[0] for p in picks], np.int64)
        metrics = scan_fn(state, images_dev, poses_dev, times_dev, img_i_k, np.stack([p[1] for p in picks]),
                          np.zeros((k,), np.float32), generator, lambda j, i=i: timer.record(i + j))
        i = i + k - 1  # the chunk's last iteration

        if i % args.i_weights == 0:
            save_tnerf_ckpt(args, checkpoint_state(mesh, state), i)
        if i % args.i_print == 0:
            timer.collect()
            m = {k: float(v) for k, v in metrics.items()}
            logger.scalars(i, m)
            tp = logger.throughput(i, samples_per_step)
            rate = f" {tp['ray_samples_per_sec_per_chip'] / 1e6:.2f}M samp/s" if tp else ""
            print(f"[TRAIN] Iter: {i} Loss: {m['loss']:.6f} PSNR: {m['psnr']:.3f}{rate}", flush=True)
            watchdog.check(i, m["psnr"])
        if i % args.i_video == 0 and i > 0:
            viddir = os.path.join(args.basedir, args.expname, f"frames_{args.expname}_spiral_{i:06d}_time")
            rgbs, disps, _ = render_path(render_fields(mesh, state)[0], None, scene.render_poses, scene, rcfg,
                                         args.chunk, savedir=viddir, eval_pass=eval_pass, times=scene.render_times,
                                         group=render_group)
            base = os.path.join(args.basedir, args.expname, f"{args.expname}_spiral_{i:06d}_")
            write_video(base + "rgb.mp4", rgbs)
            write_video(base + "disp.mp4", disps / np.max(disps))
        if i % args.i_testset == 0 and i > 0 and len(scene.i_test):
            testsavedir = os.path.join(args.basedir, args.expname, f"testset_{i:06d}")
            render_path(render_fields(mesh, state)[0], None, scene.poses[scene.i_test], scene, rcfg, args.chunk,
                        savedir=testsavedir, eval_pass=eval_pass, times=scene.times[scene.i_test],
                        group=render_group)
            print("Saved test set")
        i += 1

    timer.collect()
    logger.close()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "step_ms": timer.step_ms}


if __name__ == "__main__":
    main()
