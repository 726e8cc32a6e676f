"""D-NeRF CLI (port of ``swnerf_tpu/pipelines/run_dnerf.py``): a canonical
NeRF and a deformation MLP, shared or two-model hierarchical rendering and
the TV temporal-smoothness loss.

Training (the default) and ``--render_only`` serving::

    python -m swnerf_torch.pipelines.run_dnerf --config <cfg.txt> [--device cuda|cpu]
    python -m swnerf_torch.pipelines.run_dnerf --config <cfg.txt> --render_only --render_test

The dnerf flag set (``config_parser_dnerf``), the dynamic Blender loader,
``--nerf_type direct_temporal`` (DirectTemporalNeRF) or ``original``
(NeRFOriginal), skip 4, ``--use_two_models_for_fine``, ``--add_tv_loss``
(the same rays at a random interpolated neighbour time, penalising
``sum((dx - dx_neighbour)^2) * tv_loss_weight``, run_dnerf.py:690-725) and
the time curriculum. Training resumes from the latest ``.tar`` or native
``.msgpack`` of the experiment (or ``--ft_path``) with its Adam state and
runs one train step per iteration: the kernel step (B6, B3's pts mode, B5,
B2) where ``supports_fused_dnerf_step`` and ``utils/switches.py::kernel_step``
hold, else the eager autograd step (B6 and B7 on a card, the fp32 plain
route under ``SWNERF_FUSED=0`` or ``SWNERF_FUSED_DTYPE=f32``). It saves
``{iter:06d}.tar`` (with a fine dict for two models; and/or the native
``.msgpack``, ``SWNERF_CKPT_FORMAT``) every ``--i_weights``, renders the
test views at their frame times every ``--i_testset`` and the render path as
PNG frames and rgb / disp videos every ``--i_video``, logs the gt, rgb and
disp of a val view to TensorBoard every ``--i_img`` (where tensorboardX
imports), and prints and logs to ``metrics.jsonl`` every ``--i_print``.
``SWNERF_MAX_ITERS`` caps the iteration count (testing).
``--do_half_precision`` rounds each dense layer's inputs and weights to bf16
(fp32 products and sums) on the fields' plain route (``SWNERF_FUSED=0`` or
``SWNERF_FUSED_DTYPE=f32``), the port of the JAX package's
``Precision.DEFAULT`` there; the kernel route runs bf16 operands anyway.

Serving: ``--render_only --render_test`` renders the test views at their
frame times through the D-NeRF eval pass (B6, B3's pts mode, B2) and writes
PNG frames, the video and metrics.json; ``--render_only`` alone renders the
first render pose swept over 120 times into ``time_only/`` and the
``time_rgb`` / ``time_disp`` videos (run_dnerf.py:553-566). Steps run
``SWNERF_STEPS_PER_DISPATCH`` at a time (:func:`make_dnerf_scan_step`; 20 on
a card: CUDA-graph replays). Launched as N processes the ranks share each
step's rays and each frame's chunks (``parallel/``, as ``run_nerf``); under
``SWNERF_TENSOR_PARALLEL=k`` the canonical and deformation networks are cut
into column and row shards over a ``(rays, model)`` grid of ranks
(``parallel/tensor.py``) and train through the eager step (B2 on a card);
the saves and renders gather them, as ``run_nerf``'s.

The train split's time checks (first 0, last 1, run_dnerf.py:297-298) hold
for training only: ``--testskip`` strides the train split too, so
``--render_only --testskip 5`` loads a train split that ends before 1.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from swnerf_torch.device import resolve_device
from swnerf_torch.models import DNeRFConfig, make_dnerf_model
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
    KStepRoute,
    Scene,
    StepTimer,
    auto_reseed_loop,
    chunk_until_event,
    load_scene,
    make_time_image_step,
    neighbor_time_rng,
    pick_neighbor_time,
    render_only,
    render_path,
    seed_value,
    steps_per_dispatch,
)
from swnerf_torch.render.core import RenderConfig
from swnerf_torch.render.fused_eval import make_dnerf_eval_pass, supports_dnerf_eval_pass
from swnerf_torch.train.checkpoint import (
    dnerf_state_dict,
    native_state,
    restore_native_state,
    resume_checkpoint,
    save_checkpoint,
)
from swnerf_torch.train.fused_step import make_fused_dnerf_step, supports_fused_dnerf_step
from swnerf_torch.train.loop import TrainState, init_train_state, make_dnerf_train_step
from swnerf_torch.utils.config import config_parser_dnerf
from swnerf_torch.utils.switches import eval_pass_route, kernel_step
from swnerf_torch.utils.logging import ExperimentLogger, snapshot_args
from swnerf_torch.utils.media import write_video


def _model_config(args, depth: int, width: int) -> DNeRFConfig:
    return DNeRFConfig(
        netdepth=depth, netwidth=width, skips=(4,), multires=args.multires, multires_views=args.multires_views,
        i_embed=args.i_embed, use_viewdirs=args.use_viewdirs, output_ch=5 if args.N_importance > 0 else 4,
        zero_canonical=not args.not_zero_canonical, half_precision=args.do_half_precision,
    )


def create_dnerf(args, device: torch.device, fused: Optional[bool] = None):
    """The fields, train state, render config and eval pass from CLI args
    (reference create_nerf, run_dnerf.py:238-351), resuming from the latest
    checkpoint: weights (the fine model's too), Adam state and ``start =
    global_step``.

    Returns (state, rcfg, eval_pass, (mcfg, fcfg or None)). The eval pass
    runs B6, B3's pts mode and B2 with bf16 operands on the card and their
    fp32 plain twins on the CPU; it is None where they do not cover the
    fields (``--nerf_type original`` among them: the plain path renders
    then, as in the JAX package) and under ``SWNERF_FUSED_EVAL=0``
    (``switches.eval_pass_route``, ``dnerf.py:298-299`` there). ``fused``:
    the fields' kernel route (None: where the card and the switches take
    it; False under tensor parallelism).
    """
    kind = args.nerf_type
    mcfg = _model_config(args, args.netdepth, args.netwidth)
    generator = torch.Generator().manual_seed(seed_value())
    model = make_dnerf_model(kind, mcfg, device, generator, fused=fused)
    fine, fcfg = None, None
    if args.use_two_models_for_fine:
        fcfg = _model_config(args, args.netdepth_fine, args.netwidth_fine)
        fine = make_dnerf_model(kind, fcfg, device, generator, fused=fused)
    rcfg = RenderConfig(
        n_samples=args.N_samples, n_importance=args.N_importance, perturb=args.perturb, lindisp=args.lindisp,
        raw_noise_std=args.raw_noise_std, white_bkgd=args.white_bkgd, use_viewdirs=args.use_viewdirs,
        coarse_contributes=args.use_two_models_for_fine,
    )
    state = init_train_state(model, fine, args.lrate, args.lrate_decay, graphs=True)

    def restore_tar(ckpt):
        state.set_step(int(ckpt["global_step"]))
        model.load_state_dict(dnerf_state_dict(ckpt["network_fn_state_dict"]))
        if fine is not None and ckpt.get("network_fine_state_dict"):
            fine.load_state_dict(dnerf_state_dict(ckpt["network_fine_state_dict"]))
        if ckpt.get("optimizer_state_dict"):
            state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])

    resume_checkpoint(args.basedir, args.expname, args.ft_path, args.no_reload, lambda: native_state(state),
                      partial(restore_native_state, state), restore_tar)

    eval_pass = None
    covered = kind == "direct_temporal" and supports_dnerf_eval_pass(mcfg) and (
        fcfg is None or (supports_dnerf_eval_pass(fcfg) and (fcfg.multires, fcfg.multires_views)
                         == (mcfg.multires, mcfg.multires_views)))
    if covered and eval_pass_route(device):
        eval_pass = make_dnerf_eval_pass(mcfg, torch.bfloat16 if device.type == "cuda" else torch.float32)
    return state, rcfg, eval_pass, (mcfg, fcfg)


def save_dnerf_ckpt(args, state: TrainState, i: int) -> str:
    """``{i:06d}.tar`` with the D-NeRF schema (run_dnerf.py:757-769: the fine
    dict only for two models; the optimizer's learning rate is the
    schedule's at ``i``, as the JAX package writes it) and/or the native
    ``{i:06d}.msgpack``, as ``SWNERF_CKPT_FORMAT`` selects. Returns the
    ``.tar``'s path."""
    def tar_payload():
        opt = state.optimizer.state_dict()
        for group in opt["param_groups"]:
            group["lr"] = state.schedule(i)
        payload = {"global_step": i, "network_fn_state_dict": state.coarse.state_dict()}
        if state.fine is not None:
            payload["network_fine_state_dict"] = state.fine.state_dict()
        payload["optimizer_state_dict"] = opt
        return payload

    return save_checkpoint(args.basedir, args.expname, i, tar_payload, lambda: native_state(state))


def make_dnerf_scan_step(train_step, cfg: RenderConfig, scene: Scene, pass_neighbor: bool = True) -> Callable:
    """K time-conditioned steps per dispatch (``run_dnerf.py:218`` of the JAX
    package, which ``run_tnerf`` reuses): ``(state, images, poses, times,
    img_i_k [K], pixels_k [K, N, 2], neighbor_k [K], generator, record=None)
    -> the last step's metrics``. ``pass_neighbor=False`` (the T-NeRF step)
    ignores ``neighbor_k``, as the JAX T-NeRF passes zeros. A
    :class:`~swnerf_torch.pipelines.common.KStepRoute` over
    :func:`~swnerf_torch.pipelines.common.make_time_image_step`."""
    route = KStepRoute(make_time_image_step(train_step, cfg, scene, pass_neighbor=pass_neighbor))

    def step_k(state, images: torch.Tensor, poses: torch.Tensor, times: torch.Tensor, img_i_k: np.ndarray,
               pixels_k: np.ndarray, neighbor_k: np.ndarray, generator=None, record=None):
        draws = (img_i_k, pixels_k, neighbor_k) if pass_neighbor else (img_i_k, pixels_k)
        return route(state, (images, poses, times), draws, generator, record)

    return step_k


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
        raise ValueError(f"Unknown dataset type {args.dataset_type!r} (dnerf supports blender)")
    initialize_from_env(args.device)  # before the first device query; a no-op single-process
    device = resolve_device(args.device)
    args.dataset_type = "blender_dnerf"
    scene = load_scene(args)
    args.dataset_type = "blender"
    os.makedirs(os.path.join(args.basedir, args.expname), exist_ok=True)
    snapshot_args(args.basedir, args.expname, args, args.config)
    state, rcfg, eval_pass, (mcfg, fcfg) = create_dnerf(args, device, fused=field_route(args.render_only))
    # a mesh: the fields cut, the eager step
    mesh, group, render_group = parallel_setup(state, 0 if args.render_only else args.N_rand, args.render_only)
    start = state.step

    if args.render_only:
        print("RENDER ONLY")
        if args.render_test:
            savedir = render_only(state.coarse, state.fine, scene, rcfg, args, start, eval_pass=eval_pass,
                                  group=render_group)
        else:  # the live path: the first render pose swept over 120 times
            savedir = os.path.join(args.basedir, args.expname, "time_only")
            os.makedirs(savedir, exist_ok=True)
            poses = np.broadcast_to(scene.render_poses[0], (120, 4, 4))
            rgbs, disps, _ = render_path(state.coarse, state.fine, poses, scene, rcfg, args.chunk, savedir=savedir,
                                         render_factor=args.render_factor, eval_pass=eval_pass,
                                         times=np.linspace(0.0, 1.0, 120).astype(np.float32), group=render_group)
            base = os.path.join(args.basedir, args.expname, "time_")
            write_video(base + "rgb.mp4", rgbs)
            write_video(base + "disp.mp4", disps / np.max(disps))
        print("Done rendering", savedir)
        return savedir

    if float(scene.times[scene.i_train[0]]) != 0.0 or float(scene.times[scene.i_train[-1]]) != 1.0:
        raise ValueError("the train split's times must run from 0 to 1 (check --testskip)")
    logger = ExperimentLogger(args.basedir, args.expname)
    sampler = ImageSampler(scene, args.N_rand, args.precrop_iters, args.precrop_frac,
                           precrop_iters_time=args.precrop_iters_time)
    if (mesh is None and args.nerf_type == "direct_temporal" and supports_fused_dnerf_step(mcfg, fcfg, rcfg)
            and kernel_step(device)):
        train_step = make_fused_dnerf_step(mcfg, rcfg, fcfg=fcfg, add_tv_loss=args.add_tv_loss,
                                           tv_loss_weight=args.tv_loss_weight, group=group)
        print("Using the kernel D-NeRF train step (B6, B5, B3 pts mode, B2)")
    else:
        train_step = make_dnerf_train_step(rcfg, args.add_tv_loss, args.tv_loss_weight, group=group)
        print("Using the eager autograd train step")
    scan_fn = make_dnerf_scan_step(train_step, rcfg, scene)
    images_dev = torch.as_tensor(scene.images, device=device)
    poses_dev = torch.as_tensor(scene.poses[:, :3, :4], device=device)
    times_dev = torch.as_tensor(scene.times, device=device)
    generator = torch.Generator(device=device).manual_seed(seed_value(1))
    host_rng = neighbor_time_rng()
    k_disp = steps_per_dispatch(device)
    check_dispatch(group, device, k_disp)

    n_iters = int(os.environ.get("SWNERF_MAX_ITERS", args.N_iter + 1))
    samples_per_step = args.N_rand * (rcfg.n_samples + (rcfg.n_samples + rcfg.n_importance if rcfg.n_importance else 0))
    cadences = (args.i_weights, args.i_print, args.i_img, args.i_video, args.i_testset)
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
        neighbor_k = np.asarray([pick_neighbor_time(host_rng, scene.times, int(ii)) if args.add_tv_loss else 0.0
                                 for ii in img_i_k], np.float32)
        metrics = scan_fn(state, images_dev, poses_dev, times_dev, img_i_k, np.stack([p[1] for p in picks]),
                          neighbor_k, generator, lambda j, i=i: timer.record(i + j))
        i = i + k - 1  # the chunk's last iteration

        if i % args.i_weights == 0:
            save_dnerf_ckpt(args, checkpoint_state(mesh, state), i)
        if i % args.i_print == 0:
            timer.collect()
            m = {k: float(v) for k, v in metrics.items()}
            logger.scalars(i, m)
            tp = logger.throughput(i, samples_per_step)
            rate = f" {tp['ray_samples_per_sec_per_chip'] / 1e6:.2f}M samp/s" if tp else ""
            tv = f" TV: {m['tv']:.6f}" if "tv" in m else ""
            print(f"[TRAIN] Iter: {i} Loss_fine: {m['loss']:.6f} PSNR: {m['psnr']:.3f}{tv}{rate}", flush=True)
            watchdog.check(i, m["psnr"])
        if i % args.i_img == 0 and i > 0 and len(scene.i_val) and (logger.tb is not None or mesh is not None):
            # One val view to TensorBoard (the render is skipped where no
            # writer would take it: on every rank but 0, which renders it
            # alone, with no collective; under tensor parallelism every
            # rank gathers the fields for it first).
            fields = render_fields(mesh, state)
            if logger.tb is not None:
                img_i = int(np.random.default_rng(i).choice(scene.i_val))
                rgbs, disps, _ = render_path(*fields, scene.poses[img_i : img_i + 1], scene, rcfg, args.chunk,
                                             eval_pass=eval_pass, times=scene.times[img_i : img_i + 1])
                logger.image(i, "gt", scene.images[img_i])
                logger.image(i, "rgb", rgbs[0])
                logger.image(i, "disp", disps[0] / max(disps.max(), 1e-8))
        if i % args.i_video == 0 and i > 0:
            viddir = os.path.join(args.basedir, args.expname, f"frames_{args.expname}_spiral_{i:06d}_time")
            rgbs, disps, _ = render_path(*render_fields(mesh, state), scene.render_poses, scene, rcfg, args.chunk,
                                         savedir=viddir, eval_pass=eval_pass, times=scene.render_times,
                                         group=render_group)
            base = os.path.join(args.basedir, args.expname, f"{args.expname}_spiral_{i:06d}_")
            write_video(base + "rgb.mp4", rgbs)
            write_video(base + "disp.mp4", disps / np.max(disps))
        if i % args.i_testset == 0 and i > 0 and len(scene.i_test):
            testsavedir = os.path.join(args.basedir, args.expname, f"testset_{i:06d}")
            render_path(*render_fields(mesh, state), scene.poses[scene.i_test], scene, rcfg, args.chunk,
                        savedir=testsavedir, eval_pass=eval_pass, times=scene.times[scene.i_test],
                        group=render_group)
            print("Saved test set")
        i += 1

    timer.collect()
    logger.close()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "step_ms": timer.step_ms}


if __name__ == "__main__":
    main()
