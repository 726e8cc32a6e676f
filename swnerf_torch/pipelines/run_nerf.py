"""Vanilla NeRF CLI (port of ``swnerf_tpu/pipelines/run_nerf.py``).

Training (the default) and ``--render_only`` serving::

    python -m swnerf_torch.pipelines.run_nerf --config <cfg.txt> [--device cuda|cpu]
    python -m swnerf_torch.pipelines.run_nerf --config <cfg.txt> --render_only --render_test

Training resumes from the latest ``.tar`` of the experiment (or
``--ft_path``) with its Adam state, runs one train step per iteration
(the kernel step on B1 and B2 where ``supports_fused_step`` and
``utils/switches.py::kernel_step`` hold, else the eager autograd step,
whose fields run B7 on a card, or B8 under ``SWNERF_FUSED_RAW=1``), saves
``{iter:06d}.tar`` (and/or the native ``.msgpack``, ``SWNERF_CKPT_FORMAT``;
a native snapshot resumes too) every ``--i_weights``, renders the test
views through B3 every ``--i_testset`` and the spiral path's rgb and disp
videos every ``--i_video``, and prints and logs to ``metrics.jsonl`` (and
TensorBoard where tensorboardX imports) every ``--i_print``.
``SWNERF_MAX_ITERS`` caps the iteration count (testing).
``SWNERF_DEBUG_NANS=1`` checks each dispatch's losses and the parameters
(``utils/logging.py::DebugNans``); ``SWNERF_PROFILE_DIR`` traces
``SWNERF_PROFILE_STEPS`` steps (``utils/profiling.py::StepProfiler``).
Steps run ``SWNERF_STEPS_PER_DISPATCH`` at a time (20 on a card: one CUDA
graph of the step replayed per step, ``pipelines/common.py::KStepRoute``),
in chunks that end on every save, render, print and warm-start iteration.
``SWNERF_FUSED_DTYPE_SCHEDULE=f32@<iters>`` runs the eager step with fp32
field operands through ``<iters>`` before the kernel step (:func:`warm_start`).
Serving renders the test views or the spiral path through B3 and B2.

Launched as N processes (one per card: ``SWNERF_COORDINATOR`` /
``SWNERF_NUM_PROCESSES`` / ``SWNERF_PROCESS_ID``, or ``torchrun``), each
rank trains on its rows of every step's ray batch and the step sums the
gradients with one all-reduce (``parallel/``); the renders split each
frame's chunks over the ranks; rank 0 writes the files. Under
``SWNERF_TENSOR_PARALLEL=k`` the ranks form a ``(rays, model)`` grid
(``parallel/tensor.py``): each field's layers are cut into column and row
shards over the k ranks of a model group, the eager step runs on the
shards (B2 on a card), the saves gather the whole fields and Adam moments
and the renders whole fields on the kernel route.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from swnerf_torch.device import resolve_device
from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
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
    RayPoolSampler,
    StepTimer,
    auto_reseed_loop,
    load_scene,
    chunk_until_event,
    make_image_scan_step,
    make_pool_scan_step,
    render_only,
    render_path,
    seed_value,
    steps_per_dispatch,
)
from swnerf_torch.render.core import RenderConfig
from swnerf_torch.render.fused_eval import make_vanilla_eval_pass, supports_eval_pass
from swnerf_torch.train.checkpoint import (
    native_state,
    restore_native_state,
    resume_checkpoint,
    save_checkpoint,
    vanilla_state_dict,
)
from swnerf_torch.train.fused_step import make_fused_train_step, supports_fused_step
from swnerf_torch.train.loop import TrainState, init_train_state, make_train_step
from swnerf_torch.utils.config import config_parser
from swnerf_torch.utils.switches import eval_pass_route, kernel_step
from swnerf_torch.utils.logging import ExperimentLogger, enable_debug_nans, snapshot_args
from swnerf_torch.utils.media import write_video
from swnerf_torch.utils.profiling import StepProfiler

N_ITERS = 200000 + 1  # fixed in the vanilla runner (reference run.py:625)


def create_vanilla(args, device: torch.device, fused: Optional[bool] = None):
    """Models, train state, render config and eval pass from CLI args
    (reference create_nerf, run.py:222-311), resuming from the latest
    checkpoint: weights, Adam state and ``start = global_step``. ``fused``:
    the fields' kernel route (None: where the card and the switches take
    it; False under tensor parallelism).

    Returns (state, rcfg, eval_pass, (mcfg, fcfg)). The eval pass runs bf16
    kernel operands on the card and fp32 plain twins on the CPU; it is None
    for architectures B3 does not cover and under ``SWNERF_FUSED_EVAL=0``
    (``switches.eval_pass_route``): ``render_image`` then applies the
    fields, on their kernel route on a card.
    """
    output_ch = 5 if args.N_importance > 0 else 4
    generator = torch.Generator().manual_seed(seed_value())

    def cfg(depth, width):
        return VanillaNeRFConfig(
            netdepth=depth, netwidth=width, skips=(4,), multires=args.multires,
            multires_views=args.multires_views, i_embed=args.i_embed, use_viewdirs=args.use_viewdirs,
            output_ch=output_ch,
        )

    mcfg = cfg(args.netdepth, args.netwidth)
    model = VanillaNeRF(mcfg, device=device, generator=generator, fused=fused)
    fine_model, fcfg = None, None
    if args.N_importance > 0:
        fcfg = cfg(args.netdepth_fine, args.netwidth_fine)
        fine_model = VanillaNeRF(fcfg, device=device, generator=generator, fused=fused)

    rcfg = RenderConfig(
        n_samples=args.N_samples, n_importance=args.N_importance, perturb=args.perturb,
        lindisp=args.lindisp, raw_noise_std=args.raw_noise_std, white_bkgd=args.white_bkgd,
        use_viewdirs=args.use_viewdirs,
    )
    state = init_train_state(model, fine_model, args.lrate, args.lrate_decay, graphs=True)

    def restore_tar(ckpt):
        state.set_step(int(ckpt["global_step"]))
        model.load_state_dict(vanilla_state_dict(ckpt["network_fn_state_dict"]))
        if fine_model is not None and ckpt.get("network_fine_state_dict"):
            fine_model.load_state_dict(vanilla_state_dict(ckpt["network_fine_state_dict"]))
        if ckpt.get("optimizer_state_dict"):
            state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])

    resume_checkpoint(args.basedir, args.expname, args.ft_path, args.no_reload, lambda: native_state(state),
                      partial(restore_native_state, state), restore_tar)

    eval_pass = None
    if supports_eval_pass(mcfg, fcfg) and eval_pass_route(device):
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        eval_pass = make_vanilla_eval_pass(mcfg, compute_dtype=dtype)
    return state, rcfg, eval_pass, (mcfg, fcfg)


def save_vanilla_ckpt(args, state: TrainState, i: int) -> str:
    """``{i:06d}.tar`` with the vanilla schema (run.py:717-723; the
    optimizer's learning rate is the schedule's at ``i``, as the JAX package
    writes it) and/or the native ``{i:06d}.msgpack``, as
    ``SWNERF_CKPT_FORMAT`` selects. Returns the ``.tar``'s path."""
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


def warm_start(use_kernel_step: bool, rcfg: RenderConfig, group=None):
    """``SWNERF_FUSED_DTYPE_SCHEDULE=f32@<iters>`` (``run_nerf.py:268-287``
    of the JAX package): where the kernel step is taken, the eager autograd
    step with fp32 field operands runs through iteration ``<iters>`` and the
    bf16 kernel step after it, on the same TrainState. Returns
    ``(warm_until, warm train step or None)``; ``(0, None)`` without it."""
    sched = os.environ.get("SWNERF_FUSED_DTYPE_SCHEDULE", "")
    if not (sched and use_kernel_step):
        return 0, None
    kind, _, at = sched.partition("@")
    if kind != "f32" or not at.isdigit():
        raise ValueError(f"SWNERF_FUSED_DTYPE_SCHEDULE={sched!r}: expected 'f32@<iters>'")
    print(f"Precision warm-start: f32 autodiff step through iter {int(at)}, fused bf16 step after")
    return int(at), make_train_step(rcfg, compute_dtype=torch.float32, group=group)


def train(argv=None):
    """Product entry; with ``SWNERF_AUTO_RESEED=N`` a watchdog-confirmed
    dead-density init restarts training (at most N times) with a new seed."""
    return auto_reseed_loop(_train_impl, argv)


def _train_impl(argv=None) -> Dict:
    """The training loop (JAX ``_train_impl``: K steps a dispatch).

    Returns ``{"metrics": the last step's metrics, "step_ms": {iteration:
    device ms}}``; on the card each step's time is read from CUDA events
    recorded after every step (no synchronization in the loop)."""
    args = config_parser().parse_args(argv)
    initialize_from_env(args.device)  # before the first device query; a no-op single-process
    device = resolve_device(args.device)
    scene = load_scene(args)
    os.makedirs(os.path.join(args.basedir, args.expname), exist_ok=True)
    snapshot_args(args.basedir, args.expname, args, args.config)
    state, rcfg, eval_pass, (mcfg, fcfg) = create_vanilla(args, device, fused=field_route())
    mesh, group, render_group = parallel_setup(state, args.N_rand)  # a mesh: the fields cut, the eager step
    start = state.step
    logger = ExperimentLogger(args.basedir, args.expname)

    use_kernel_step = mesh is None and supports_fused_step(mcfg, fcfg, rcfg) and kernel_step(device)
    if use_kernel_step:
        train_step = make_fused_train_step(mcfg, rcfg, fcfg=fcfg, group=group)
        print("Using the kernel train step (B1 render-loss, B2 sample_pdf)")
    else:
        train_step = make_train_step(rcfg, group=group)
        print("Using the eager autograd train step")
    warm_until, warm_train_step = warm_start(use_kernel_step, rcfg, group)
    generator = torch.Generator(device=device).manual_seed(seed_value(1))

    # K steps per dispatch: each chunk's steps are replays of one CUDA graph
    # on a card (KStepRoute); SWNERF_STEPS_PER_DISPATCH=1 dispatches each.
    k_disp = steps_per_dispatch(device)
    check_dispatch(group, device, k_disp)
    nan_check = None
    if os.environ.get("SWNERF_DEBUG_NANS") == "1":
        # Opt-in analog of the reference's always-on anomaly detection
        # (utils.py:2): each step records its loss on the device (captured
        # with the step), each dispatch ends in one check.
        nan_check = enable_debug_nans([p for m in state.modules() for p in m.parameters()], k_disp)
        train_step = nan_check.wrap(train_step)
        warm_train_step = warm_train_step and nan_check.wrap(warm_train_step)
    profiler = StepProfiler()
    make_scan = make_image_scan_step if args.no_batching else make_pool_scan_step
    scan_fn = make_scan(train_step, rcfg, scene)
    warm_scan_fn = make_scan(warm_train_step, rcfg, scene) if warm_train_step is not None else None
    if args.no_batching:
        sampler = ImageSampler(scene, args.N_rand, args.precrop_iters, args.precrop_frac)
        images_dev = torch.as_tensor(scene.images, device=device)
        poses_dev = torch.as_tensor(scene.poses[:, :3, :4], device=device)

        def run_chunk(fn, i, k, record):
            picks = [sampler.next(i + j) for j in range(k)]
            img_i_k = np.asarray([p[0] for p in picks], np.int64)
            return fn(state, images_dev, poses_dev, img_i_k, np.stack([p[1] for p in picks]), generator, record)
    else:
        sampler = RayPoolSampler(scene, args.N_rand, device)

        def run_chunk(fn, i, k, record):
            return fn(state, sampler.pool, np.stack([sampler.next_indices() for _ in range(k)]), generator, record)

    n_iters = int(os.environ.get("SWNERF_MAX_ITERS", N_ITERS))
    samples_per_step = args.N_rand * (rcfg.n_samples + (rcfg.n_samples + rcfg.n_importance if rcfg.n_importance else 0))
    # warm_until is a chunk boundary too, so no dispatch mixes the two steps.
    cadences = (args.i_weights, args.i_video, args.i_testset, args.i_print, warm_until)
    print("Training Begin")
    print("TRAIN views are", scene.i_train)
    print("TEST views are", scene.i_test)
    # Auto-reseed restarts are legal only before the first checkpoint, and
    # never on a resumed run.
    watchdog = DeadInitWatchdog(args.i_print, restart_until=args.i_weights if start == 0 else 0)
    timer = StepTimer(device, start)

    metrics = {}
    i = start + 1
    try:
        while i < n_iters:
            k = chunk_until_event(i, n_iters, k_disp, cadences)
            # The whole chunk lies on one side of warm_until (a cadence).
            if i > warm_until and warm_scan_fn is not None:
                warm_scan_fn = None  # the warm start is over: its graph's pool goes
            fn = warm_scan_fn if i <= warm_until else scan_fn
            profiler.step(i, start)
            if nan_check is not None:
                nan_check.begin(i, k)
            metrics = run_chunk(fn, i, k, lambda j, i=i: timer.record(i + j))
            if nan_check is not None:
                nan_check.check()
            i = i + k - 1  # the chunk's last iteration

            if i % args.i_weights == 0:
                save_vanilla_ckpt(args, checkpoint_state(mesh, state), i)
            if i % args.i_video == 0 and i > 0:
                rgbs, disps, _ = render_path(*render_fields(mesh, state), scene.render_poses, scene, rcfg, args.chunk,
                                             eval_pass=eval_pass, group=render_group)
                base = os.path.join(args.basedir, args.expname, f"{args.expname}_spiral_{i:06d}_")
                write_video(base + "rgb.mp4", rgbs)
                write_video(base + "disp.mp4", disps / np.max(disps))
            if i % args.i_testset == 0 and i > 0 and len(scene.i_test):
                testsavedir = os.path.join(args.basedir, args.expname, f"testset_{i:06d}")
                os.makedirs(testsavedir, exist_ok=True)
                render_path(*render_fields(mesh, state), scene.poses[scene.i_test], scene, rcfg, args.chunk,
                            savedir=testsavedir, eval_pass=eval_pass, group=render_group)
                print("Saved test set")
            if i % args.i_print == 0:
                timer.collect()
                m = {k: float(v) for k, v in metrics.items()}
                logger.scalars(i, m)
                tp = logger.throughput(i, samples_per_step)
                rate = f" {tp['ray_samples_per_sec_per_chip'] / 1e6:.2f}M samp/s" if tp else ""
                print(f"[TRAIN] Iter: {i} Loss: {m['total_loss']:.6f}  PSNR: {m['psnr']:.3f}{rate}", flush=True)
                watchdog.check(i, m["psnr"])
            i += 1
    finally:  # a trace still running is written, and the profiler stops, whatever ended the loop
        profiler.close(i - 1)
    timer.collect()
    logger.close()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "step_ms": timer.step_ms}


def main(argv=None):
    """CLI entry. Returns the render directory of ``--render_only``, else
    what :func:`train` returns."""
    args = config_parser().parse_args(argv)
    initialize_from_env(args.device)
    device = resolve_device(args.device)
    if not args.render_only:
        return train(argv)
    scene = load_scene(args)
    os.makedirs(os.path.join(args.basedir, args.expname), exist_ok=True)
    state, rcfg, eval_pass, _ = create_vanilla(args, device, fused=field_route(render_only=True))
    _, _, group = parallel_setup(state, render_only=True)
    print("RENDER ONLY")
    savedir = render_only(state.coarse, state.fine, scene, rcfg, args, state.step, eval_pass=eval_pass, group=group)
    print("Done rendering", savedir)
    return savedir


if __name__ == "__main__":
    main()
