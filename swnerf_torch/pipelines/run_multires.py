"""MultiRes D-NeRF CLI (port of ``swnerf_tpu/pipelines/run_multires.py``):
one D-NeRF field per Laplacian-pyramid level, trained in two phases.

    python -m swnerf_torch.pipelines.run_multires --config configs/multires/lego.txt [--device cuda|cpu]

* ``--layer_num`` levels with the per-level (position, time, view)
  frequencies ``CHANNEL_LIST`` (-1: the identity) and cameras ``H / 2^l``,
  ``focal / 2^l``;
* phase 1: each level alone, coarsest first, ``--global_optimization_epoch``
  steps (``SWNERF_PHASE1_ITERS`` overrides) of the eager D-NeRF step
  (``make_dnerf_train_step``: the TV re-render at a neighbour time) on the
  level's Gaussian image;
* phase 2: every level renders an aligned patch (32 pixels at level 0,
  halved per level, corners drawn centre-biased on the coarsest level and
  doubled upward); the loss is each level's MSE against its Laplacian band
  plus, from iteration ``--global_optimization_epoch`` on, the MSE of the
  pyramid reconstruction against the full-resolution patch; one backward,
  then every level's Adam;
* per-level ``.tar`` keys ``network_fn_{l}``, ``network_fine_{l}``,
  ``optimizer_{l}`` (the JAX package's layout; torch Adam's state), the
  auto-resume, the early exit of a finished run, and the ``--i_testset``
  per-level renders reconstructed to PNGs.

On the card each field runs kernels B6 and B7 (``models/dnerf.py``'s kernel
route, bf16 operands; the fp32 plain route under ``SWNERF_FUSED=0`` or
``SWNERF_FUSED_DTYPE=f32``) in both phases. The test-set renders and the
``--i_video`` time sweep run levels 0-2 through the D-NeRF eval pass (B6,
then B3's pts mode at the MultiRes widths: ``make_level_eval_passes``, the
eval pass ``make_dnerf_field`` attaches there, models/dnerf.py:294-306),
and the identity level 3 through its fields, as on the TPU;
``SWNERF_FUSED_EVAL=0`` renders every level through its fields.
``SWNERF_FUSED_MULTIRES`` (``"1"``, or a per-level list ``"1,0,0,0"``)
runs phase 2 fused on the chosen levels (``make_phase2_step(fused=...)``):
B6 under autograd, then B3's pts mode forward and kernel B9 as its
backward (``render_loss.render_outputs_autograd``), so the pyramid
reconstruction's gradient reaches every level through the kernels; on the
CPU the twins stand in. The host stream (patch corners, image indices,
neighbour times) is seeded from ``SWNERF_SEED``; at seed 0 it draws the JAX
package's (which hard-codes 0). ``SWNERF_CKPT_FORMAT`` selects the
``.tar`` and/or the native ``.msgpack`` (``{"params_all", "opt_states"}``,
the JAX package's MultiRes snapshot), and either resumes. ``--i_video``
writes each level's PNG frames and the reconstructed video. Launched as N
processes (``parallel/``, as ``run_nerf``) the ranks share phase 1's rays
and each level's phase-2 patch (:func:`make_phase2_step`) and each test
frame's chunks; rank 0 writes the files. Under
``SWNERF_TENSOR_PARALLEL=k`` every level's fields and Adam moments are cut
into column and row shards over one ``(rays, model)`` grid of ranks
(``parallel/tensor.py``; the policy's batch is ``gcd(N_rand, the smallest
patch^2)``), phase 2 takes the field route, and the saves and test renders
gather every level. The JAX package's MultiRes has no K-step dispatch, so
the port gives it none. ``SWNERF_MAX_ITERS`` caps the iteration count
(testing).
"""

from __future__ import annotations

import dataclasses
import math
import os
import statistics
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from swnerf_torch.device import resolve_device
from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, make_dnerf_model
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import render_loss as b1
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.ops.kernels import time_net as b6
from swnerf_torch.ops.pyramid import generate_gaussian_pyramid, generate_laplacian_pyramid, reconstruct_from_pyramid
from swnerf_torch.ops.rays import get_rays_at
from swnerf_torch.ops.sampling import sample_along_rays
from swnerf_torch.parallel import (
    RaysGroup,
    TensorMesh,
    all_reduce_rows,
    batch_rows,
    checkpoint_state,
    field_route,
    initialize_from_env,
    is_primary,
    parallel_setup,
    reducer_for,
    render_fields,
)
from swnerf_torch.pipelines.common import (
    ImageSampler,
    Scene,
    StepTimer,
    load_scene,
    make_time_image_step,
    neighbor_time_rng,
    pick_neighbor_time,
    render_path,
    seed_value,
)
from swnerf_torch.render.core import Draws, RenderConfig, build_rays, make_draws, render_rays
from swnerf_torch.render.fused_eval import (
    DNeRFEvalPass,
    _dists_scaled,
    canonical_params,
    make_dnerf_eval_pass,
    supports_dnerf_eval_pass,
)
from swnerf_torch.train.checkpoint import (
    dnerf_state_dict,
    native_state,
    restore_native_state,
    resume_checkpoint,
    save_checkpoint,
)
from swnerf_torch.train.loop import TrainState, init_train_state, make_dnerf_train_step, mse, mse_to_psnr
from swnerf_torch.utils.config import config_parser_dnerf
from swnerf_torch.utils.logging import ExperimentLogger, snapshot_args
from swnerf_torch.utils.media import write_png, write_video
from swnerf_torch.utils.switches import eval_pass_route, fused_multires, operand_dtype

# (position, time, view) frequencies per level; -1 = identity (multires_dnerf.py:665-668).
CHANNEL_LIST = [(20, 8, 20), (10, 4, 10), (10, 4, 10), (-1, -1, -1)]
BASE_PATCH_SIZE = 32  # highest-resolution patch edge (multires_dnerf.py:726)
CENTER_ONLY_ITERS = 4000  # get_random_patch_coords n (multires_dnerf.py:500)


def get_random_patch_coords(rng: np.random.Generator, H: int, W: int, patch_size: int, current_iter: int,
                            n: int = CENTER_ONLY_ITERS, sigma_factor: float = 4.0) -> Tuple[int, int]:
    """Centre-biased patch corner (multires_dnerf.py:500-561): uniform in the
    central quarter for the first ``n`` iterations, then Gaussian about the
    centre, clamped; (0, 0) when the patch does not fit."""
    if H <= patch_size or W <= patch_size:
        return 0, 0
    center_y = (H - patch_size) / 2.0
    center_x = (W - patch_size) / 2.0
    if current_iter < n:
        min_y = max(0, int(center_y - H / 8.0))
        max_y = min(int(center_y + H / 8.0), H - patch_size)
        min_x = max(0, int(center_x - W / 8.0))
        max_x = min(int(center_x + W / 8.0), W - patch_size)
        y = int(rng.integers(min_y, max_y + 1))
        x = int(rng.integers(min_x, max_x + 1))
    else:
        y = int(rng.normal(center_y, H / sigma_factor))
        x = int(rng.normal(center_x, W / sigma_factor))
        y = max(0, min(y, H - patch_size))
        x = max(0, min(x, W - patch_size))
    return y, x


def initialize_patches(rng: np.random.Generator, pyr_hwf: List[List[float]], cur_iter: int,
                       base_patch_size: int = BASE_PATCH_SIZE) -> List[Tuple[int, int]]:
    """Aligned per-level patch corners, finest first: drawn on the coarsest
    level (with the full base patch size, as the reference does,
    multires_dnerf.py:562-585) and doubled per finer level."""
    coords: List[Tuple[int, int]] = []
    for layer, (H, W, _) in enumerate(pyr_hwf[::-1]):
        if layer == 0:
            coords.append(get_random_patch_coords(rng, int(H), int(W), base_patch_size, cur_iter))
        else:
            py, px = coords[layer - 1]
            coords.append((py * 2, px * 2))
    return coords[::-1]


def _level_cfg(args, channels) -> DNeRFConfig:
    pos, tim, view = channels
    return DNeRFConfig(
        netdepth=args.netdepth, netwidth=args.netwidth, skips=(4,), multires=pos, multires_views=view,
        multires_time=tim, i_embed=0 if pos != -1 else -1, use_viewdirs=args.use_viewdirs,
        output_ch=5 if args.N_importance > 0 else 4, zero_canonical=not args.not_zero_canonical,
    )


def _adam_steps(opt_state: Dict) -> int:
    """The update count in a torch Adam state dict (0 when it has none)."""
    for entry in opt_state.get("state", {}).values():
        return int(torch.as_tensor(entry["step"]).item())
    return 0


def create_multires(args, scene: Scene, device: torch.device, fused: Optional[bool] = None):
    """Per-level fields, train states (Adam each) and cameras, with the
    per-level ``.tar`` auto-resume (multires_dnerf.py:242-346, 629-668).
    Returns (kind, states, pyr_hwf, rcfg, start); a level's ``step`` is its
    Adam update count, which its learning-rate schedule reads. ``fused``:
    the fields' kernel route (None: where the card and the switches take
    it; False under tensor parallelism)."""
    kind = args.nerf_type
    generator = torch.Generator().manual_seed(seed_value())
    states, pyr_hwf = [], []
    for layer in range(args.layer_num):
        cfg = _level_cfg(args, CHANNEL_LIST[layer % len(CHANNEL_LIST)])
        coarse = make_dnerf_model(kind, cfg, device, generator, fused=fused)
        fine = make_dnerf_model(kind, cfg, device, generator, fused=fused) if args.use_two_models_for_fine else None
        states.append(init_train_state(coarse, fine, args.lrate, args.lrate_decay))
        scale = 2**layer
        pyr_hwf.append([scene.H // scale, scene.W // scale, scene.focal / scale])

    def restore_tar(ckpt):
        for layer, st in enumerate(states):
            st.coarse.load_state_dict(dnerf_state_dict(ckpt[f"network_fn_{layer}"]))
            if st.fine is not None and ckpt.get(f"network_fine_{layer}"):
                st.fine.load_state_dict(dnerf_state_dict(ckpt[f"network_fine_{layer}"]))
            st.optimizer.load_state_dict(ckpt[f"optimizer_{layer}"])
            st.set_step(_adam_steps(ckpt[f"optimizer_{layer}"]))

    start = resume_checkpoint(args.basedir, args.expname, args.ft_path, args.no_reload,
                              lambda: native_multires(states),
                              lambda payload, step: restore_native_multires(states, payload), restore_tar)

    rcfg = RenderConfig(
        n_samples=args.N_samples, n_importance=args.N_importance, perturb=args.perturb, lindisp=args.lindisp,
        raw_noise_std=args.raw_noise_std, white_bkgd=args.white_bkgd, use_viewdirs=args.use_viewdirs,
        coarse_contributes=args.use_two_models_for_fine,
    )
    return kind, states, pyr_hwf, rcfg, start


def make_level_eval_passes(states: List[TrainState], device: torch.device) -> List[Optional[DNeRFEvalPass]]:
    """Per level, the D-NeRF eval pass ``make_dnerf_field`` attaches to it
    (models/dnerf.py:294-306 there): a DirectTemporalNeRF with the Fourier
    encoding (``i_embed == 0``) whose widths B3's pts mode and B6 take,
    where ``switches.eval_pass_route`` holds (bf16 on the card, the fp32
    twins on the CPU). At the config's channels that is levels 0-2; the
    identity level 3 gets None and renders through its fields."""
    out: List[Optional[DNeRFEvalPass]] = []
    for st in states:
        cfg = getattr(st.coarse, "cfg", None)
        ok = (isinstance(st.coarse, DirectTemporalNeRF) and cfg.i_embed == 0 and supports_dnerf_eval_pass(cfg)
              and eval_pass_route(device))
        out.append(make_dnerf_eval_pass(cfg, torch.bfloat16 if device.type == "cuda" else torch.float32)
                   if ok else None)
    return out


def native_multires(states: List[TrainState]) -> Dict:
    """The JAX package's MultiRes snapshot state (run_multires.py:223 there)
    in state-dict form: ``{"params_all": {"l": {"coarse", "fine"}},
    "opt_states": {"l": optax's chain state}}``, from each level's models and
    torch Adam."""
    levels = [native_state(st) for st in states]
    return {"params_all": {str(l): lv["params"] for l, lv in enumerate(levels)},
            "opt_states": {str(l): lv["opt_state"] for l, lv in enumerate(levels)}}


def restore_native_multires(states: List[TrainState], payload: Dict) -> None:
    """The inverse of :func:`native_multires`: each level's weights and
    Adam, its step its Adam count (as the ``.tar`` resume sets it)."""
    for layer, st in enumerate(states):
        opt_state = payload["opt_states"][str(layer)]
        restore_native_state(st, {"params": payload["params_all"][str(layer)], "opt_state": opt_state},
                             step=int(opt_state["0"]["count"]))


def save_multires_ckpt(args, states: List[TrainState], i: int) -> str:
    """``{i:06d}.tar`` with per-level keys (multires_dnerf.py:1010-1024):
    ``network_fn_{l}``, ``network_fine_{l}`` (two models only) and
    ``optimizer_{l}``, whose learning rate is the level's schedule at its
    update count; and/or the native ``{i:06d}.msgpack``, as
    ``SWNERF_CKPT_FORMAT`` selects. Returns the ``.tar``'s path."""
    def tar_payload():
        payload = {"global_step": i}
        for layer, st in enumerate(states):
            payload[f"network_fn_{layer}"] = st.coarse.state_dict()
            if st.fine is not None:
                payload[f"network_fine_{layer}"] = st.fine.state_dict()
            opt = st.optimizer.state_dict()
            for group in opt["param_groups"]:
                group["lr"] = st.schedule(st.step)
            payload[f"optimizer_{layer}"] = opt
        return payload

    return save_checkpoint(args.basedir, args.expname, i, tar_payload, lambda: native_multires(states))


def level_scene(scene: Scene, hwf, images: Optional[np.ndarray] = None) -> Scene:
    """The scene at a pyramid level's camera (and, for phase 1, images)."""
    H, W, focal = hwf
    return dataclasses.replace(
        scene, images=scene.images if images is None else images, H=int(H), W=int(W), focal=float(focal),
        K=np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]]),
    )


def supports_fused_phase2(model, rcfg: RenderConfig) -> bool:
    """A level can run phase 2 fused (run_multires.py:226-240 there): a
    DirectTemporalNeRF whose canonical trunk B3's pts mode and B9 take (the
    wide widths, the identity level too) and whose deformation MLP B6
    takes, rendered in one pass (the joint patch step has no fine pass)."""
    cfg = getattr(model, "cfg", None)
    return (
        isinstance(model, DirectTemporalNeRF)
        and b3.supports_config(cfg, wide=True)
        and b6.supports_time_net(cfg)
        and cfg.i_embed in (0, -1)
        and rcfg.n_importance == 0
    )


def _can_fuse(st: TrainState, rcfg: RenderConfig) -> bool:
    return supports_fused_phase2(st.coarse, rcfg) and st.fine is None  # the joint step has no fine pass


def fused_levels(states: List[TrainState], rcfg: RenderConfig, device) -> List[bool]:
    """Per level, whether phase 2 runs it fused: ``SWNERF_FUSED_MULTIRES``
    (``switches.fused_multires``) on the levels that can."""
    return fused_multires(device, [_can_fuse(st, rcfg) for st in states])


def make_phase2_step(rcfg: RenderConfig, pyr_hwf, patch_sizes: List[int], near: float, far: float,
                     fused=None, compute_dtype: Optional[torch.dtype] = None, group: Optional[RaysGroup] = None):
    """The joint step (``make_phase2_step`` of the JAX package,
    run_multires.py:243-407): ``(states, pixels_all, targets_all,
    target_full, pose, t, gw, generator=None, draws=None) -> metrics``.
    Every level renders its patch of ``pixels_all[l]`` [ps^2, 2] at frame
    time ``t``, adds its MSE against ``targets_all[l]`` [ps, ps, 3] (its
    Laplacian band), then ``gw`` times the MSE of the reconstructed patches
    against ``target_full``; one backward, then each level's Adam.

    ``fused`` chooses per level how it renders: None reads
    ``SWNERF_FUSED_MULTIRES`` (:func:`fused_levels`), a bool for all
    levels, or a list. An unfused level renders through its fields (``render_rays``); a fused level runs ``fused_rgb`` (run_multires.py:
    306-344 there): the stratified z from the draws, dx by B6 under autograd
    on the detached positions, the ``t == 0`` mask, then
    ``render_outputs_autograd`` at ``pts + dx`` (B3's pts mode, B9 as its
    backward) with ``compute_dtype`` operands (None: bf16 on the card, fp32
    on the CPU, whose twins stand in). ``draws`` (one ``Draws`` per level)
    or ``generator`` give the random numbers: the JAX package renders every
    level of every phase-2 step with one key (run_multires.py:622), the port
    draws fresh numbers each time.

    ``group`` (``parallel/mesh.py``; the JAX package shards each level's
    patch pixels under ``shard_cli_step`` and GSPMD spans the
    reconstruction): each rank renders its rows of every level's patch
    (with those rows of the whole patch's draws), the whole patches are
    assembled detached by one all-reduce of zero-filled buffers, every rank
    computes the same loss on them and its gradient with respect to the
    patches, backpropagates its rows' slice of it through its own renders,
    and one all-reduce sums the parameter gradients of every level. The
    metrics are the whole patches' on every rank."""
    L = len(pyr_hwf)
    reducer = reducer_for(group)

    def fused_rgb(st: TrainState, rays, dl: Draws, dtype: torch.dtype) -> torch.Tensor:
        cfg = st.coarse.cfg
        params = dict(st.coarse.named_parameters())
        pdt = next(st.coarse.parameters()).dtype  # float32; float64 for a float64 reference run on the twins
        canon = b3.pack_params(canonical_params(params), cfg, pdt)
        tnet = b6.pack_time_params(params, cfg, pdt)
        z = sample_along_rays(rays.near, rays.far, rcfg.n_samples, rcfg.perturb, rcfg.lindisp,
                              t_rand=dl.t_rand).contiguous()
        pts = (rays.origins[:, None, :] + rays.directions[:, None, :] * z[..., None]).contiguous()
        t = rays.times.reshape(-1).to(pts.dtype).contiguous()
        dx = b6.time_net_autograd(tnet, dtype, pts, t)
        if cfg.zero_canonical:
            dx = torch.where((t == 0.0)[:, None, None], torch.zeros_like(dx), dx)
        noise = dl.noise0.contiguous() if rcfg.raw_noise_std > 0.0 and dl.noise0 is not None else None
        vd_emb = positional_encoding(rays.viewdirs, cfg.nf_views).contiguous()
        out = b1.render_outputs_autograd(canon, dtype, (pts + dx).contiguous(), vd_emb, z,
                                         _dists_scaled(z, rays.directions).contiguous(), noise, rcfg.white_bkgd)
        return out["rgb"]

    def step(states: List[TrainState], pixels_all, targets_all, target_full, pose, t: float, gw: float,
             generator: Optional[torch.Generator] = None, draws: Optional[List[Draws]] = None):
        device = pixels_all[0].device
        if fused is None:
            flags = fused_levels(states, rcfg, device)
        else:
            flags = [fused] * L if isinstance(fused, bool) else list(fused)
            bad = [l for l, st in enumerate(states) if flags[l] and not _can_fuse(st, rcfg)]
            if bad:
                raise ValueError(f"make_phase2_step: levels {bad} cannot run phase 2 fused")
        dtype = operand_dtype(device, compute_dtype)
        for st in states:
            st.zero_grad()
        renders = []
        for l in range(L):
            H, W, focal = pyr_hwf[l]
            ps = patch_sizes[l]
            rows = batch_rows(group, ps * ps)
            pixels = rows.take(pixels_all[l])
            rays_o, rays_d = get_rays_at(pixels, int(H), int(W), float(focal), pose)
            times = torch.full((pixels.shape[0], 1), float(t), dtype=torch.float32, device=pixels.device)
            rays = build_rays(rays_o, rays_d, near, far, use_viewdirs=rcfg.use_viewdirs, times=times)
            dl = rows.take_fields(make_draws(rcfg, ps * ps, generator, device) if draws is None else draws[l])
            if flags[l]:
                out = {"rgb": fused_rgb(states[l], rays, dl, dtype)}
            else:
                out = render_rays(states[l].coarse, rays, rcfg, fine_model=states[l].fine, draws=dl)
            renders.append(({k: out[k] for k in ("rgb", "rgb0") if k in out}, rows))
        if group is None:
            maps = [out for out, _ in renders]
        else:  # the whole patches, detached, as leaves of the loss
            local = [(out[k], rows) for out, rows in renders for k in out]
            whole_maps = all_reduce_rows(group, [x for x, _ in local], [r for _, r in local])
            for x in whole_maps:
                x.requires_grad_(True)
            it = iter(whole_maps)
            maps = [{k: next(it) for k in out} for out, _ in renders]
        total = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        outs = []
        for l, out in enumerate(maps):
            ps = patch_sizes[l]
            rgb = out["rgb"].reshape(ps, ps, 3)
            img_loss = mse(rgb, targets_all[l])
            total = total + img_loss
            metrics[f"loss_layer_{l}"] = img_loss.detach()
            metrics[f"psnr_layer_{l}"] = mse_to_psnr(img_loss.detach())
            if "rgb0" in out:
                l0 = mse(out["rgb0"].reshape(ps, ps, 3), targets_all[l])
                total = total + l0
                metrics[f"loss0_layer_{l}"] = l0.detach()
            outs.append(rgb[None])
        global_loss = mse(reconstruct_from_pyramid(outs)[0], target_full)
        total = total + gw * global_loss
        metrics["global_loss"] = global_loss.detach()
        metrics["global_psnr"] = mse_to_psnr(global_loss.detach())
        metrics["total_loss"] = total.detach()
        total.backward()
        if group is not None:  # each rank's rows of the patches' gradient, through its own renders
            torch.autograd.backward([x for x, _ in local], [w.grad[r.lo : r.hi] for (_, r), w in zip(local, whole_maps)])
            reducer([p for st in states for m in st.modules() for p in m.parameters()])
        for st in states:
            st.apply_update()
        return metrics

    return step


def render_testset(args, scene: Scene, states: List[TrainState], pyr_hwf, rcfg: RenderConfig, i: int,
                   eval_passes: Optional[List[Optional[DNeRFEvalPass]]] = None, group: Optional[RaysGroup] = None
                   ) -> Tuple[np.ndarray, float, List[torch.Tensor]]:
    """Every level renders the test views at their frame times
    (``layer_{l}/``) through its eval pass where ``eval_passes`` gives one
    (:func:`make_level_eval_passes`), else through its fields, and the
    reconstructions go to
    ``recon_{k:03d}.png`` in ``testset_{i:06d}``. Returns the reconstructed
    frames [T, H, W, 3] (clipped to [0, 1]), the milliseconds per
    reconstructed frame (every level's render and the reconstruction; on a
    card between two synchronizations; the PNG writes come after) and each
    level's frames [T, H / 2^l, W / 2^l, 3] as rendered. With a ``group``
    the ranks share each frame's chunks (``render_path``)."""
    testsavedir = os.path.join(args.basedir, args.expname, f"testset_{i:06d}")
    device = next(states[0].coarse.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    level_frames = []
    for l, st in enumerate(states):
        rgbs, _, _ = render_path(st.coarse, st.fine, scene.poses[scene.i_test], level_scene(scene, pyr_hwf[l]), rcfg,
                                 args.chunk, eval_pass=eval_passes[l] if eval_passes else None,
                                 times=scene.times[scene.i_test], group=group)
        level_frames.append(torch.as_tensor(rgbs))
    recon = reconstruct_from_pyramid(level_frames).clamp(0.0, 1.0).numpy()
    ms = (time.perf_counter() - t0) * 1e3 / max(len(scene.i_test), 1)
    for l, frames in enumerate(level_frames):
        for k, frame in enumerate(frames.numpy()):
            write_png(os.path.join(testsavedir, f"layer_{l}", f"{k:03d}.png"), frame)
    for k, frame in enumerate(recon):
        write_png(os.path.join(testsavedir, f"recon_{k:03d}.png"), frame)
    print(f"Saved test set reconstructed images ({ms:.1f} ms per reconstructed frame)")
    return recon, ms, level_frames


def render_time_sweep(args, scene: Scene, states: List[TrainState], pyr_hwf, rcfg: RenderConfig, i: int,
                      eval_passes: Optional[List[Optional[DNeRFEvalPass]]] = None,
                      group: Optional[RaysGroup] = None) -> None:
    """The first render pose swept over ``SWNERF_VIDEO_FRAMES`` (120) times
    per level (through its eval pass where ``eval_passes`` gives one; PNG
    frames per level), reconstructed to the ``_reconstructed_{i}_rgb``
    video (run_multires.py:639-661)."""
    n = int(os.environ.get("SWNERF_VIDEO_FRAMES", 120))
    poses = np.broadcast_to(scene.render_poses[0], (n, 4, 4))
    times = np.linspace(0, 1, n).astype(np.float32)
    level_frames = []
    for l, st in enumerate(states):
        savedir = os.path.join(args.basedir, args.expname, f"frames_layer_{l}_{i:06d}_time")
        rgbs, _, _ = render_path(st.coarse, st.fine, poses, level_scene(scene, pyr_hwf[l]), rcfg, args.chunk,
                                 savedir=savedir, eval_pass=eval_passes[l] if eval_passes else None, times=times,
                                 group=group)
        level_frames.append(torch.as_tensor(rgbs))
    recon = reconstruct_from_pyramid(level_frames).clamp(0.0, 1.0).numpy()
    write_video(os.path.join(args.basedir, args.expname, f"{args.expname}_reconstructed_{i:06d}_rgb.mp4"), recon)


def render_states(mesh: Optional[TensorMesh], states: List[TrainState]) -> List[TrainState]:
    """The states the renders read: ``states`` without a grid, else each
    level's whole fields gathered once for the call
    (``parallel/tensor.py::render_fields``)."""
    if mesh is None:
        return states
    return [dataclasses.replace(st, coarse=c, fine=f) for st in states for c, f in [render_fields(mesh, st)]]


def _median(ms: Dict[int, float]) -> Optional[float]:
    return statistics.median(ms.values()) if ms else None


def train(argv=None) -> Dict:
    """The CLI. Returns ``{"metrics": the last phase-2 step's metrics,
    "phase1_loss": {level: the printed losses}, "phase1_step_ms": {level:
    {iteration: device ms}}, "phase2_step_ms": {iteration: device ms},
    "test_frame_ms": ms per reconstructed test frame (None without a test
    render)}``; the step times are CUDA events after every step (empty on
    the CPU)."""
    args = config_parser_dnerf().parse_args(argv)
    if args.dataset_type != "blender":
        raise ValueError(f"Unknown dataset type {args.dataset_type!r} (multires supports blender)")
    initialize_from_env(args.device)  # before the first device query; a no-op single-process
    device = resolve_device(args.device)
    args.dataset_type = "blender_dnerf"
    scene = load_scene(args)
    args.dataset_type = "blender"
    os.makedirs(os.path.join(args.basedir, args.expname), exist_ok=True)
    snapshot_args(args.basedir, args.expname, args, args.config)
    logger = ExperimentLogger(args.basedir, args.expname)
    log_txt = os.path.join(args.basedir, args.expname, "log.txt")
    L = args.layer_num

    # The base patch, clamped to the image (the largest power of two <= min(H, W)).
    base_ps = BASE_PATCH_SIZE
    while base_ps > 1 and base_ps > min(scene.H, scene.W):
        base_ps //= 2
    if base_ps != BASE_PATCH_SIZE:
        print(f"Patch size clamped to {base_ps} for {scene.H}x{scene.W} images")
    patch_sizes = [max(base_ps // (2**l), 1) for l in range(L)]

    kind, states, pyr_hwf, rcfg, start = create_multires(args, scene, device, fused=field_route())
    # a mesh: every level cut over one grid, at a batch that divides N_rand and every patch
    mesh, group, render_group = parallel_setup(states, args.N_rand,
                                               tp_batch_size=math.gcd(args.N_rand, min(patch_sizes) ** 2))
    eval_passes = make_level_eval_passes(states, device)
    result: Dict = {"metrics": {}, "phase1_loss": {}, "phase1_step_ms": {}, "phase2_step_ms": {},
                    "test_frame_ms": None}
    n_iters = int(os.environ.get("SWNERF_MAX_ITERS", args.N_iter + 1))
    if start + 1 >= n_iters:
        # Resumed at or past the end: phase 2 would not run, so phase 1 (which
        # a resume repeats, as the reference does) would be wasted.
        print(f"Checkpoint at iter {start} >= N_iter {n_iters - 1}: training already complete, nothing to do "
              "(pass --no_reload to retrain).")
        logger.close()
        return result

    images = torch.as_tensor(scene.images, device=device)
    with torch.no_grad():
        lap_bands = generate_laplacian_pyramid(images, levels=L)
        gauss_levels = generate_gaussian_pyramid(images, levels=L)
    pyr_dir = os.path.join(args.basedir, args.expname, "pyramid_images")
    for li, band in enumerate(lap_bands):
        for n in range(min(4, band.shape[0])):
            write_png(os.path.join(pyr_dir, f"image_{li}_{n}.png"), band[n].cpu().numpy())

    generator = torch.Generator(device=device).manual_seed(seed_value(1))
    # The host stream of patch corners, image indices and neighbour times,
    # seeded from SWNERF_SEED (the JAX package hard-codes 0,
    # run_multires.py:529; at seed 0 the two draw the same).
    rng = neighbor_time_rng()
    poses_dev = torch.as_tensor(scene.poses[:, :3, :4], device=device)
    times_dev = torch.as_tensor(scene.times, device=device)

    # ---------------- phase 1: each level alone, coarsest first
    phase1_iters = int(os.environ.get("SWNERF_PHASE1_ITERS", args.global_optimization_epoch))
    train_step = make_dnerf_train_step(rcfg, args.add_tv_loss, args.tv_loss_weight, group=group)
    for layer in reversed(range(L)):
        print(f"=== Phase 1: private pretrain, level {layer} ===")
        lscene = level_scene(scene, pyr_hwf[layer], gauss_levels[layer].cpu().numpy())
        sampler = ImageSampler(lscene, args.N_rand, args.precrop_iters, args.precrop_frac,
                               precrop_iters_time=args.precrop_iters_time)
        step_fn = make_time_image_step(train_step, rcfg, lscene, pass_neighbor=True)
        timer = StepTimer(device, -1)
        losses = []
        for i in range(phase1_iters):
            img_i, pixels = sampler.next(i)
            nt = pick_neighbor_time(rng, scene.times, img_i) if args.add_tv_loss else 0.0
            metrics = step_fn(states[layer], gauss_levels[layer], poses_dev, times_dev, img_i, pixels, nt, generator)
            timer.record(i)
            if i % args.i_print == 0:
                m = {f"pretrain_l{layer}_{k}": float(v) for k, v in metrics.items()}
                logger.scalars(i, m)
                losses.append(float(metrics["loss"]))
                line = f"[PRETRAIN] Layer {layer} Iter: {i} Loss: {float(metrics['loss']):.6f} " \
                       f"PSNR: {float(metrics['psnr']):.3f}"
                print(line, flush=True)
                if is_primary():
                    with open(log_txt, "a") as f:
                        f.write(line + "\n")
        timer.collect()
        result["phase1_loss"][layer] = losses
        result["phase1_step_ms"][layer] = timer.step_ms
        med = _median(timer.step_ms)
        if med is not None:
            print(f"[MULTIRES] phase 1 level {layer}: median {med:.3f} ms per step over {len(timer.step_ms)} steps")

    # ---------------- phase 2: joint patch optimization
    fused = [False] * L if mesh is not None else fused_levels(states, rcfg, device)  # kernels read whole weights
    step_fn = make_phase2_step(rcfg, pyr_hwf, patch_sizes, scene.near, scene.far, fused=fused, group=group)
    print(f"Begin joint training (fused phase 2 on levels {[l for l, f in enumerate(fused) if f]})")
    timer = StepTimer(device, start)
    metrics = {}
    for i in range(start + 1, n_iters):
        coords = initialize_patches(rng, pyr_hwf, i, base_patch_size=base_ps)
        img_i = int(rng.choice(scene.i_train))
        t = float(scene.times[img_i])
        pixels_all, targets_all = [], []
        for l in range(L):
            y, x = coords[l]
            ps = patch_sizes[l]
            ys, xs = np.meshgrid(np.arange(y, y + ps), np.arange(x, x + ps), indexing="ij")
            pixels_all.append(torch.as_tensor(np.stack([ys, xs], -1).reshape(-1, 2), device=device))
            targets_all.append(lap_bands[l][img_i, y : y + ps, x : x + ps])
        y0, x0 = coords[0]
        target_full = images[img_i, y0 : y0 + patch_sizes[0], x0 : x0 + patch_sizes[0]]
        gw = 1.0 if i >= args.global_optimization_epoch else 0.0
        metrics = step_fn(states, pixels_all, targets_all, target_full, poses_dev[img_i], t, gw, generator)
        timer.record(i)

        if i % args.i_weights == 0:
            save_multires_ckpt(args, [checkpoint_state(mesh, st) for st in states], i)
        if i % args.i_print == 0:
            m = {k: float(v) for k, v in metrics.items()}
            logger.scalars(i, m)
            line = (f"[GLOBAL OPT] Iter: {i} Global Loss: {m['global_loss']:.6f} "
                    f"Global PSNR: {m['global_psnr']:.2f}, Coords: {coords[0]}")
            print(line, flush=True)
            if is_primary():
                with open(log_txt, "a") as f:
                    f.write(line + "\n")
        render_video = i % args.i_video == 0 and i > 0
        render_test = i % args.i_testset == 0 and i > 0 and len(scene.i_test)
        if render_video or render_test:  # the renders stay out of the step times
            timer.collect()
            result["phase2_step_ms"].update(timer.step_ms)
            if render_video:
                render_time_sweep(args, scene, render_states(mesh, states), pyr_hwf, rcfg, i, eval_passes,
                                  render_group)
            if render_test:
                _, result["test_frame_ms"], _ = render_testset(args, scene, render_states(mesh, states), pyr_hwf,
                                                               rcfg, i, eval_passes, render_group)
            timer = StepTimer(device, i)

    timer.collect()
    result["phase2_step_ms"].update(timer.step_ms)
    med = _median(result["phase2_step_ms"])
    if med is not None:
        print(f"[MULTIRES] phase 2: median {med:.3f} ms per step over {len(result['phase2_step_ms'])} steps")
    logger.close()
    result["metrics"] = {k: float(v) for k, v in metrics.items()}
    return result


main = train

if __name__ == "__main__":
    main()
