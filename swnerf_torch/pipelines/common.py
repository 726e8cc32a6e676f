"""Shared pipeline machinery (port of ``swnerf_tpu/pipelines/common.py``):
dataset dispatch, the training ray samplers and step wrappers, the
dead-init watchdog with auto-reseed, path rendering and the video and
eval-metrics dump of ``--render_only``. ``load_scene`` takes every
``dataset_type`` of the JAX package's.

The samplers stay numpy and, unlike the JAX package's, are seeded from
``SWNERF_SEED``; at seed 0 they draw exactly the JAX samplers' indices.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from swnerf_torch.ops.kernels import launches
from swnerf_torch.ops.rays import get_rays_at, get_rays_np
from swnerf_torch.parallel.multihost import is_primary
from swnerf_torch.render.core import RenderConfig, build_rays, make_rays_from_camera, render_image
from swnerf_torch.utils.media import write_png, write_video
from swnerf_torch.utils.metrics import LPIPS_UNAVAILABLE_NOTE, calculate_metrics


@dataclasses.dataclass
class Scene:
    """Loaded dataset + camera/bounds metadata."""

    images: np.ndarray  # [N, H, W, 3] float32 (already background-composited)
    poses: np.ndarray  # [N, 4, 4] or [N, 3, 4]
    render_poses: np.ndarray
    H: int
    W: int
    focal: float
    K: np.ndarray  # [3, 3]
    near: float
    far: float
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: np.ndarray
    ndc: bool = False
    times: Optional[np.ndarray] = None  # [N] frame times of a dynamic scene
    render_times: Optional[np.ndarray] = None  # one per render pose


def _composite_background(images: np.ndarray, white_bkgd: bool) -> np.ndarray:
    if images.shape[-1] == 4:
        if white_bkgd:
            return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        return images[..., :3]
    return images


def load_scene(args) -> Scene:
    """Dataset dispatch (reference run.py:431-511): ``llff`` (NDC rays unless
    ``--no_ndc``; every ``llffhold``-th view held out for test and val),
    ``blender``, ``blender_dnerf`` (the time-conditioned trainers':
    ``--render_test`` also renders at the test frames' times), ``LINEMOD``,
    ``deepvoxels`` and ``custom``. ``K`` is the loader's where it gives
    one."""
    K = None
    times = render_times = None
    ndc = False
    if args.dataset_type == "llff":
        from swnerf_torch.data.llff import load_llff_data

        images, poses, bds, render_poses, i_test = load_llff_data(
            args.datadir, args.factor, recenter=True, bd_factor=0.75, spherify=args.spherify
        )
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        if args.llffhold > 0:
            i_test = np.arange(images.shape[0])[:: args.llffhold]
        else:
            i_test = np.array([i_test])
        i_val = i_test
        i_train = np.array([i for i in np.arange(images.shape[0]) if i not in i_test and i not in i_val])
        if args.no_ndc:
            near, far = float(bds.min() * 0.9), float(bds.max() * 1.0)
        else:
            near, far = 0.0, 1.0
            ndc = True
    elif args.dataset_type == "blender":
        from swnerf_torch.data.blender import load_blender_data

        images, poses, render_poses, hwf, (i_train, i_val, i_test) = load_blender_data(
            args.datadir, args.half_res, args.testskip
        )
        near, far = 2.0, 6.0
        images = _composite_background(images, args.white_bkgd)
    elif args.dataset_type == "blender_dnerf":
        from swnerf_torch.data.blender import load_blender_dynamic_data

        images, poses, times, render_poses, render_times, hwf, (i_train, i_val, i_test) = (
            load_blender_dynamic_data(args.datadir, args.half_res, args.testskip)
        )
        near, far = 2.0, 6.0
        images = _composite_background(images, args.white_bkgd)
    elif args.dataset_type == "LINEMOD":
        from swnerf_torch.data.linemod import load_linemod_data

        images, poses, render_poses, hwf, K, (i_train, i_val, i_test), near, far = load_linemod_data(
            args.datadir, args.half_res, args.testskip
        )
        images = _composite_background(images, args.white_bkgd)
    elif args.dataset_type == "deepvoxels":
        from swnerf_torch.data.deepvoxels import load_dv_data

        images, poses, render_poses, hwf, (i_train, i_val, i_test) = load_dv_data(
            scene=args.shape, basedir=args.datadir, testskip=args.testskip
        )
        hemi_r = float(np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1)))
        near, far = hemi_r - 1.0, hemi_r + 1.0
    elif args.dataset_type == "custom":
        from swnerf_torch.data.custom import load_custom_data

        images, poses, render_poses, K, hwf, (i_train, i_val, i_test) = load_custom_data(
            args.datadir, args.half_res, args.testskip
        )
        near, far = 1.0, 6.0
        images = _composite_background(images, args.white_bkgd)
    else:
        raise ValueError(f"Unknown dataset type {args.dataset_type!r}")

    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    if K is None:
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    K = np.asarray(K, dtype=np.float64)
    if getattr(args, "render_test", False):
        render_poses = np.array(poses[i_test])
        if times is not None:
            render_times = np.array(times[i_test])
    return Scene(
        images=np.asarray(images, np.float32),
        poses=np.asarray(poses, np.float32),
        render_poses=np.asarray(render_poses, np.float32),
        H=H, W=W, focal=focal, K=K, near=float(near), far=float(far),
        i_train=np.asarray(i_train), i_val=np.asarray(i_val), i_test=np.asarray(i_test),
        ndc=ndc, times=times, render_times=render_times,
    )


# ---------------------------------------------------------------------------
# Ray sampling strategies
# ---------------------------------------------------------------------------


def seed_value(offset: int = 0) -> int:
    """``SWNERF_SEED + offset``, moved to a distinct seed per auto-reseed
    attempt (``SWNERF_RESEED_ATTEMPT``), so attempt k is reproducible."""
    seed = int(os.environ.get("SWNERF_SEED", "0")) + offset
    attempt = reseed_attempt()
    return seed + (attempt << 32) if attempt else seed


class RayPoolSampler:
    """Pre-shuffled all-image ray pool (reference use_batching path,
    run.py:601-650). The pool ``[Np, 3, 3]`` (origin, direction, rgb) lives
    on ``device``; the host walks a numpy permutation and hands out
    ``[N_rand]`` index slices."""

    def __init__(self, scene: Scene, n_rand: int, device, seed: Optional[int] = None):
        rays = np.stack([get_rays_np(scene.H, scene.W, scene.K, p[:3, :4]) for p in scene.poses], 0)
        rays = np.transpose(rays, [0, 2, 3, 1, 4])[scene.i_train]  # [Nt, H, W, 2, 3]
        rgb = scene.images[scene.i_train][..., None, :3]
        pool = np.concatenate([rays, rgb], -2).reshape(-1, 3, 3).astype(np.float32)
        self._rng = np.random.default_rng(int(os.environ.get("SWNERF_SEED", "0")) if seed is None else seed)
        self.pool = torch.as_tensor(pool, device=device)
        self.n = pool.shape[0]
        self.n_rand = n_rand
        self._perm = self._rng.permutation(self.n)
        self._i = 0

    def next_indices(self) -> np.ndarray:
        if self._i + self.n_rand > self.n:
            self._perm = self._rng.permutation(self.n)
            self._i = 0
        idx = self._perm[self._i : self._i + self.n_rand]
        self._i += self.n_rand
        return idx.astype(np.int64)


class ImageSampler:
    """Per-image random pixels with the center-crop curriculum (reference
    no_batching path, run.py:652-681) and, for dynamic scenes, the time
    curriculum (``precrop_iters_time``, run_dnerf.py:650-655): the host picks
    the image and the (row, col) pixels; rays for just those pixels are made
    on the device."""

    def __init__(self, scene: Scene, n_rand: int, precrop_iters: int, precrop_frac: float, seed: Optional[int] = None,
                 precrop_iters_time: int = 0):
        self.scene = scene
        self.n_rand = n_rand
        self.precrop_iters = precrop_iters
        self.precrop_iters_time = precrop_iters_time
        self._rng = np.random.default_rng(int(os.environ.get("SWNERF_SEED", "0")) if seed is None else seed)
        H, W = scene.H, scene.W
        dH, dW = int(H // 2 * precrop_frac), int(W // 2 * precrop_frac)
        ys, xs = np.meshgrid(np.arange(H // 2 - dH, H // 2 + dH), np.arange(W // 2 - dW, W // 2 + dW), indexing="ij")
        self._crop_coords = np.stack([ys, xs], -1).reshape(-1, 2).astype(np.int64)
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        self._full_coords = np.stack([ys, xs], -1).reshape(-1, 2).astype(np.int64)

    def next(self, step: int) -> Tuple[int, np.ndarray]:
        i_train = self.scene.i_train
        if step >= self.precrop_iters_time:
            img_i = int(self._rng.choice(i_train))
        else:  # the reachable frame range grows linearly
            max_sample = max(int(step / float(self.precrop_iters_time) * len(i_train)), 3)
            img_i = int(self._rng.choice(i_train[:max_sample]))
        coords = self._crop_coords if step < self.precrop_iters else self._full_coords
        # Fewer pixels than N_rand in the region: draw with replacement.
        replace = coords.shape[0] < self.n_rand
        sel = self._rng.choice(coords.shape[0], size=self.n_rand, replace=replace)
        return img_i, coords[sel]


def _scene_rays(rays_o, rays_d, cfg: RenderConfig, scene: Scene):
    return build_rays(
        rays_o, rays_d, scene.near, scene.far, use_viewdirs=cfg.use_viewdirs, ndc=scene.ndc,
        H=scene.H, W=scene.W, focal=scene.focal,
    )


def _intrinsics(scene: Scene) -> Callable[[torch.Tensor], torch.Tensor]:
    """``scene.K`` in ``c2w``'s dtype on its device, copied there once (a copy
    from the host at every step would synchronize, and a step captured in a
    CUDA graph may not copy)."""
    cache = {}

    def K_like(c2w: torch.Tensor) -> torch.Tensor:
        key = (c2w.dtype, c2w.device)
        if key not in cache:
            cache[key] = torch.as_tensor(scene.K, dtype=c2w.dtype, device=c2w.device)
        return cache[key]

    return K_like


def _at(x: torch.Tensor, img_i) -> torch.Tensor:
    """``x[img_i]`` for a Python int, or for a 0-d index tensor on ``x``'s
    device (what the dispatch loop passes), read there with no host
    synchronization (indexing with a 0-d tensor reads it on the host)."""
    if isinstance(img_i, torch.Tensor):
        return x.index_select(0, img_i.reshape(1))[0]
    return x[img_i]


def _target(images: torch.Tensor, img_i, pixels: torch.Tensor) -> torch.Tensor:
    """``images[img_i]`` at ``pixels`` [N, 2], ``img_i`` as for :func:`_at`."""
    if isinstance(img_i, torch.Tensor):
        img_i = img_i.reshape(1)
    return images[img_i, pixels[:, 0], pixels[:, 1]]


def make_pool_step(train_step, cfg: RenderConfig, scene: Scene) -> Callable:
    """Wrap a train step to consume ``(state, pool, idx, generator)``: gather
    origins, directions and targets from the device pool at ``idx`` (a
    device tensor, or host indices). Under data parallelism the pool is
    replicated and ``idx`` is the global batch's, which a step built with a
    group cuts to its rank's rows."""

    def step(state, pool: torch.Tensor, idx, generator=None):
        batch = pool[torch.as_tensor(idx, device=pool.device)]
        rays = _scene_rays(batch[:, 0], batch[:, 1], cfg, scene)
        return train_step(state, rays, batch[:, 2].contiguous(), generator)

    return step


def make_image_step(train_step, cfg: RenderConfig, scene: Scene) -> Callable:
    """Wrap a train step to consume ``(state, images, poses, img_i, pixels,
    generator)`` with images ``[N, H, W, 3]`` and poses ``[N, 3, 4]`` on the
    device: rays only at the chosen pixels, targets gathered there.
    ``img_i`` is an int or a 0-d device tensor, ``pixels`` a device tensor
    or host coordinates."""

    K_like = _intrinsics(scene)

    def step(state, images: torch.Tensor, poses: torch.Tensor, img_i, pixels, generator=None):
        pixels = torch.as_tensor(pixels, device=images.device)
        c2w = _at(poses, img_i)
        rays_o, rays_d = get_rays_at(pixels, scene.H, scene.W, K_like(c2w), c2w)
        target = _target(images, img_i, pixels)
        return train_step(state, _scene_rays(rays_o, rays_d, cfg, scene), target, generator)

    return step


def make_time_image_step(train_step, cfg: RenderConfig, scene: Scene, pass_neighbor: bool = False) -> Callable:
    """Wrap a train step to consume ``(state, images, poses, times, img_i,
    pixels, generator)`` with ``times`` [N] on the device: as
    :func:`make_image_step`, every ray carrying the frame time of image
    ``img_i`` in ``rays.times``. With ``pass_neighbor`` (the D-NeRF steps)
    it consumes ``(state, images, poses, times, img_i, pixels,
    neighbor_time, generator)`` and forwards the TV loss's neighbour time (a
    float or a 0-d device tensor)."""

    K_like = _intrinsics(scene)

    def rays_and_target(images, poses, times, img_i, pixels):
        pixels = torch.as_tensor(pixels, device=images.device)
        c2w = _at(poses, img_i)
        rays_o, rays_d = get_rays_at(pixels, scene.H, scene.W, K_like(c2w), c2w)
        target = _target(images, img_i, pixels)
        t = _at(times, img_i).reshape(1, 1).expand(pixels.shape[0], 1).contiguous()
        return build_rays(rays_o, rays_d, scene.near, scene.far, use_viewdirs=cfg.use_viewdirs, times=t), target

    if pass_neighbor:
        def step(state, images: torch.Tensor, poses: torch.Tensor, times: torch.Tensor, img_i, pixels,
                 neighbor_time, generator=None):
            rays, target = rays_and_target(images, poses, times, img_i, pixels)
            return train_step(state, rays, target, neighbor_time, generator)

        return step

    def step(state, images: torch.Tensor, poses: torch.Tensor, times: torch.Tensor, img_i, pixels,
             generator=None):
        rays, target = rays_and_target(images, poses, times, img_i, pixels)
        return train_step(state, rays, target, generator)

    return step


# ---------------------------------------------------------------------------
# K steps per dispatch
# ---------------------------------------------------------------------------


def steps_per_dispatch(device) -> int:
    """How many train steps a trainer dispatches at a time (the JAX
    package's ``steps_per_dispatch``, 20 on a TPU): 20 on a card, where the
    chunk's steps are replays of one CUDA graph (:class:`KStepRoute`), and
    1 on the CPU. ``SWNERF_STEPS_PER_DISPATCH`` overrides it (at least 1)."""
    env = os.environ.get("SWNERF_STEPS_PER_DISPATCH")
    if env:
        return max(1, int(env))
    return 20 if torch.device(device).type == "cuda" else 1


def chunk_until_event(i: int, n_iters: int, k_max: int, cadences) -> int:
    """Largest k <= k_max such that steps i..i+k-1 cross no cadence boundary
    except at the chunk's END, so checkpoints, prints, renders and the warm
    start's switch land on exactly the iterations of a one-step loop
    (``common.py:456-465`` of the JAX package). A cadence of 0 or None is
    none."""
    k = min(k_max, n_iters - i)
    for c in cadences:
        if c and c > 0:
            k = min(k, c - ((i - 1) % c))
    return max(1, k)


class KStepRoute:
    """``k`` train steps a call, the port of the JAX package's K-step
    dispatch (``lax.scan`` over a chunk's host draws): ``route(state, fixed,
    draws_k, generator, record)`` runs ``step(state, *fixed, *row_j,
    generator)`` for each row ``j`` of ``draws_k`` (numpy ``[k, ...]``
    arrays: the chunk's host draws) and returns the last step's metrics.

    On the CPU that is a loop, each row's draws as CPU tensors. On a card the
    rows enter the step as device tensors (0-d for a scalar draw): static
    buffers, each filled before its step from a pinned copy of the chunk (a
    new one a chunk, so no host write races a pending copy). The first chunk
    of two or more steps runs its first step uncaptured on the capture
    stream (the warm-up: kernel builds and ``lru_cache``s, scratch sizes,
    Adam's and autograd's state), captures the step once in a
    ``torch.cuda.CUDAGraph`` and replays it for each further step; later
    chunks replay it for every step. Before the capture a one-step chunk
    runs uncaptured, so ``SWNERF_STEPS_PER_DISPATCH=1`` never captures.
    Nothing is caught: a capture that meets a host synchronization raises.

    The capture runs nothing, so its host side effects are undone and
    repeated per replay: ``state.step`` is restored and advances by one a
    replay (the device count advances in the graph), and ``launches`` gains
    the counts that the capture recorded on every replay. ``generator`` is
    registered with the graph, whose replays advance it as uncaptured steps
    would. The graph is bound to the state, the fixed inputs and the
    generator it was captured with; a call with others captures anew (a new
    trainer run after a resume or an auto-reseed builds new routes anyway).
    ``record(j)`` runs once step ``j`` is enqueued (the trainers'
    :class:`StepTimer`).

    Under data parallelism the draws are each step's global batch, staged
    whole (a step built with a group takes its rank's rows on the device).
    Under NCCL the step's one all-reduce is captured with it (the first,
    uncaptured step also sets up the communicator); gloo collectives cannot
    be captured, and the trainers refuse K > 1 under gloo on a card
    (``mesh.check_dispatch``)."""

    def __init__(self, step: Callable):
        self.step = step
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._bound: tuple = ()
        self._static: List[torch.Tensor] = []
        self._out = None
        self._launches: collections.Counter = collections.Counter()
        self._stream = None

    def __call__(self, state, fixed: tuple, draws_k: tuple, generator=None,
                 record: Optional[Callable[[int], None]] = None):
        record = record or (lambda j: None)
        k = len(draws_k[0])
        dev = next(state.coarse.parameters()).device
        if dev.type != "cuda":
            for j in range(k):
                metrics = self.step(state, *fixed, *(torch.as_tensor(d[j]) for d in draws_k), generator)
                record(j)
            return metrics
        staged = [torch.from_numpy(np.ascontiguousarray(d)).pin_memory() for d in draws_k]
        bound = (state, *fixed, generator)
        shapes = [(x.shape[1:], x.dtype) for x in staged]
        same = len(bound) == len(self._bound) and all(a is b for a, b in zip(bound, self._bound))
        if not same or [(x.shape, x.dtype) for x in self._static] != shapes:
            self.graph, self._out, self._bound = None, None, bound
            self._static = [torch.empty(shape, dtype=dtype, device=dev) for shape, dtype in shapes]
        first = 0
        if self.graph is None:
            self._load(staged, 0)
            if k == 1:
                metrics = self.step(state, *fixed, *self._static, generator)
                record(0)
                return metrics
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            main = torch.cuda.current_stream(dev)
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                self.step(state, *fixed, *self._static, generator)
            main.wait_stream(self._stream)
            record(0)
            self._capture(state, fixed, generator, dev)
            first = 1
        for j in range(first, k):
            self._load(staged, j)
            self.graph.replay()
            launches.update(self._launches)
            state.step += 1
            record(j)
        return self._out

    def _load(self, staged: List[torch.Tensor], j: int) -> None:
        for buf, rows in zip(self._static, staged):
            buf.copy_(rows[j], non_blocking=True)

    def _capture(self, state, fixed: tuple, generator, dev) -> None:
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before, step = collections.Counter(launches), state.step
        with torch.cuda.graph(graph, stream=self._stream):
            self._out = self.step(state, *fixed, *self._static, generator)
        recorded = collections.Counter(launches)
        recorded.subtract(before)
        self._launches = +recorded
        launches.clear()
        launches.update(before)
        state.step = step
        self.graph = graph
        pool = torch.cuda.memory_reserved(dev) - reserved
        print(f"Captured the train step in a CUDA graph: {pool / 2**20:.1f} MiB in its pool, "
              f"{sum(self._launches.values())} kernel launches a replay", flush=True)


def make_pool_scan_step(train_step, cfg: RenderConfig, scene: Scene) -> Callable:
    """K pool steps per dispatch (``common.py:407`` of the JAX package):
    ``(state, pool, idx_k [K, N_rand], generator, record=None) -> the last
    step's metrics``, what a one-step loop would print at the chunk's end.
    A :class:`KStepRoute` over :func:`make_pool_step`."""
    route = KStepRoute(make_pool_step(train_step, cfg, scene))

    def step_k(state, pool: torch.Tensor, idx_k: np.ndarray, generator=None, record=None):
        return route(state, (pool,), (idx_k,), generator, record)

    return step_k


def make_image_scan_step(train_step, cfg: RenderConfig, scene: Scene) -> Callable:
    """K per-image steps per dispatch (``common.py:430`` there): ``(state,
    images, poses, img_i_k [K], pixels_k [K, N_rand, 2], generator,
    record=None) -> the last step's metrics``; the host keeps the precrop
    curriculum and the image choice. A :class:`KStepRoute` over
    :func:`make_image_step`."""
    route = KStepRoute(make_image_step(train_step, cfg, scene))

    def step_k(state, images: torch.Tensor, poses: torch.Tensor, img_i_k: np.ndarray, pixels_k: np.ndarray,
               generator=None, record=None):
        return route(state, (images, poses), (img_i_k, pixels_k), generator, record)

    return step_k


def neighbor_time_rng(seed: Optional[int] = None) -> np.random.Generator:
    """The host generator of the TV loss's neighbour times, seeded from
    ``SWNERF_SEED`` (the JAX package hard-codes 0, run_dnerf.py:421: at seed 0
    the two draw the same times)."""
    return np.random.default_rng(int(os.environ.get("SWNERF_SEED", "0")) if seed is None else seed)


def pick_neighbor_time(rng: np.random.Generator, times: np.ndarray, img_i: int) -> float:
    """A random previous or next frame, and a random interpolation toward
    it (run_dnerf.py:690-709; swnerf_tpu/pipelines/run_dnerf.py:261-275)."""
    t = float(times[img_i])
    t_prev = float(times[img_i - 1]) if img_i > 0 else None
    t_next = float(times[img_i + 1]) if img_i < len(times) - 1 else None
    if t_prev is not None and t_next is not None:
        if rng.random() > 0.5:
            t_prev = None
        else:
            t_next = None
    if t_prev is not None:
        return t_prev + (t - t_prev) * float(rng.random())
    return t + (t_next - t) * float(rng.random())


class StepTimer:
    """Per-step device milliseconds: a CUDA event recorded after every step
    (each replay of a chunk's graph: :class:`KStepRoute` calls
    :meth:`record` once a step), read only at :meth:`collect` (no
    synchronization inside the loop). Records nothing on the CPU."""

    def __init__(self, device: torch.device, start: int):
        self.cuda = device.type == "cuda"
        self._events: dict = {}
        self.step_ms: dict = {}
        self.record(start)

    def record(self, i: int) -> None:
        if self.cuda:
            self._events[i] = torch.cuda.Event(enable_timing=True)
            self._events[i].record()

    def collect(self) -> None:
        """Wait for the newest event and turn the gaps up to it into
        ``step_ms[i]`` (ms between the ends of steps i-1 and i)."""
        if len(self._events) < 2:
            return
        done = sorted(self._events)
        self._events[done[-1]].synchronize()
        for a, b in zip(done[:-1], done[1:]):
            self.step_ms[b] = self._events[a].elapsed_time(self._events[b])
        self._events = {done[-1]: self._events[done[-1]]}


# ---------------------------------------------------------------------------
# Dead-init watchdog and auto-reseed
# ---------------------------------------------------------------------------


class DeadInitDetected(RuntimeError):
    """A watchdog-confirmed dead-density init draw, eligible for an
    auto-restart (raised only while SWNERF_AUTO_RESEED budget remains)."""


def reseed_attempt() -> int:
    """Current auto-reseed attempt counter (0 = the original seed)."""
    return int(os.environ.get("SWNERF_RESEED_ATTEMPT", "0") or 0)


def auto_reseed_loop(train_once, argv=None):
    """Run a trainer, restarting with a new init seed (:func:`seed_value`)
    when :class:`DeadInitWatchdog` confirms the dead-density draw. Opt-in via
    ``SWNERF_AUTO_RESEED=N`` (at most N restarts); restarts happen only
    before the first checkpoint, so auto-resume never reloads a dead run."""
    prev = os.environ.get("SWNERF_RESEED_ATTEMPT")
    budget = int(os.environ.get("SWNERF_AUTO_RESEED", "0") or 0)
    try:
        while True:
            try:
                return train_once(argv)
            except DeadInitDetected:
                attempt = reseed_attempt() + 1
                if attempt > budget:
                    raise
                print(f"[AUTO-RESEED] attempt {attempt}/{budget}: reinitializing with a new seed "
                      "and restarting from iter 0")
                os.environ["SWNERF_RESEED_ATTEMPT"] = str(attempt)
    finally:
        if prev is None:
            os.environ.pop("SWNERF_RESEED_ATTEMPT", None)
        else:
            os.environ["SWNERF_RESEED_ATTEMPT"] = prev


class DeadInitWatchdog:
    """Warn once (or, with auto-reseed budget left before the first
    checkpoint, raise :class:`DeadInitDetected`) when a run's printed PSNR
    stays flat below the constant-background floor.

    A negative density-bias draw leaves the network ReLU-dead with zero
    gradients; it renders the constant background forever. "Flat" here is
    the mean of the newer half of the last ``window`` prints rising by less
    than ``spread_db`` over the older half. The JAX package tests
    ``max - min < 0.02 dB`` instead, which the minibatch noise of a dead run
    never passes (under ``--raw_noise_std 1`` least of all), so its watchdog
    cannot fire; half-window means average that noise out.
    """

    def __init__(self, print_cadence: int, min_iter: int = 500, window: int = 8, floor_db: float = 16.0,
                 restart_until: int = 0):
        self.print_cadence = int(print_cadence) if print_cadence else 1
        # SWNERF_WATCHDOG_* are test-scale hooks: tiny scenes have another floor.
        self.min_iter = int(os.environ.get("SWNERF_WATCHDOG_MIN_ITER", min_iter))
        self.window = window
        self.floor_db = float(os.environ.get("SWNERF_WATCHDOG_FLOOR", floor_db))
        self.spread_db = float(os.environ.get("SWNERF_WATCHDOG_SPREAD", 0.5))
        self.restart_until = restart_until
        self.history: list = []
        self.warned = False

    def check(self, i: int, psnr: float) -> None:
        self.history.append(float(psnr))
        del self.history[: -self.window]
        if self.warned or i < self.min_iter or len(self.history) < self.window:
            return
        half = self.window // 2
        older, newer = self.history[:half], self.history[-half:]
        rise = sum(newer) / len(newer) - sum(older) / len(older)
        if max(self.history) >= self.floor_db or rise >= self.spread_db:
            return
        budget = int(os.environ.get("SWNERF_AUTO_RESEED", "0") or 0)
        if budget and reseed_attempt() < budget and i < self.restart_until:
            print(f"[AUTO-RESEED] PSNR flat at {psnr:.2f} dB through iter {i}: dead-density init confirmed; "
                  "restarting with a reseeded init (SWNERF_AUTO_RESEED)")
            raise DeadInitDetected(f"dead init at iter {i} (psnr {psnr:.2f})")
        self.warned = True
        print(f"[WARN] PSNR has been flat at {psnr:.2f} dB for {self.window * self.print_cadence} iters: this seed "
              "likely drew the dead-density init (zero gradients). Restart with a different SWNERF_SEED, add "
              "`--raw_noise_std 1e0`, or set SWNERF_SAFE_INIT=1.")


def render_path(
    model,
    fine_model,
    poses: np.ndarray,
    scene: Scene,
    cfg: RenderConfig,
    chunk: int,
    savedir: Optional[str] = None,
    render_factor: int = 0,
    eval_pass=None,
    times: Optional[np.ndarray] = None,
    group=None,
) -> Tuple[np.ndarray, np.ndarray, List[float]]:
    """Render a pose path (reference render_path run.py:172-219) on the
    model's device, pose i at frame time ``times[i]`` for a time-conditioned
    field. Returns (rgbs [T, H, W, 3], disps [T, H, W], seconds per frame);
    on a card each frame is timed between two synchronizations. With a
    ``group`` every rank renders its chunks of each frame and holds the
    whole frame (``render_image``); only rank 0 writes the PNGs."""
    H, W, K = scene.H, scene.W, scene.K.copy()
    if render_factor != 0:
        H, W = H // render_factor, W // render_factor
        K = K / render_factor
        K[2, 2] = 1.0
    device = next(model.parameters()).device
    ecfg = cfg.eval_mode()
    rgbs, disps, seconds = [], [], []
    for i, c2w in enumerate(poses):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        rays = make_rays_from_camera(
            H, W, K, c2w[:3, :4], scene.near, scene.far, use_viewdirs=ecfg.use_viewdirs, ndc=scene.ndc,
            device=device, time=None if times is None else float(times[i]),
        )
        out = render_image(model, rays, ecfg, chunk=chunk, fine_model=fine_model, eval_pass=eval_pass, group=group)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        rgb = out["rgb"].reshape(H, W, 3).cpu().numpy()
        disp = out["disp"].reshape(H, W).cpu().numpy()
        rgbs.append(rgb)
        disps.append(disp)
        if savedir is not None:
            write_png(os.path.join(savedir, f"{i:03d}.png"), rgb)
        print(f"render_path {i}/{len(poses)} {seconds[-1]:.3f}s", flush=True)
    return np.stack(rgbs), np.stack(disps), seconds


def render_only(model, fine_model, scene: Scene, cfg: RenderConfig, args, start: int, eval_pass=None,
                group=None) -> str:
    """The --render_only path (run.py:557-596): render the test poses or
    the spiral path (at ``scene.render_times`` for a dynamic scene), write
    PNGs and ``video.mp4`` (a GIF without cv2, ``utils/media.py``), and
    metrics.json when the ground truth is known: PSNR, SSIM and LPIPS (alex,
    on the model's device, where ``SWNERF_LPIPS_DIR`` holds its weights;
    null with a note otherwise). metrics.json also records each frame's
    render seconds. With a ``group`` the ranks share each frame's chunks
    (:func:`render_path`) and rank 0 writes the files and scores them."""
    suffix = "test" if args.render_test else "path"
    savedir = os.path.join(args.basedir, args.expname, f"renderonly_{suffix}_{start:06d}")
    os.makedirs(savedir, exist_ok=True)
    rgbs, _, seconds = render_path(
        model, fine_model, scene.render_poses, scene, cfg, chunk=args.chunk, savedir=savedir,
        render_factor=args.render_factor, eval_pass=eval_pass, times=scene.render_times, group=group,
    )
    if not is_primary():
        return savedir
    write_video(os.path.join(savedir, "video.mp4"), rgbs)
    payload = {"seconds_per_frame": seconds}
    if args.render_test and args.render_factor == 0:
        gt = scene.images[scene.i_test]
        device = next(model.parameters()).device
        metrics = [calculate_metrics(g, p, device=device) for g, p in zip(gt, rgbs)]
        payload.update(psnr=[m[0] for m in metrics], ssim=[m[1] for m in metrics], lpips=[m[2] for m in metrics])
        if any(m[2] is None for m in metrics):
            payload["lpips_note"] = LPIPS_UNAVAILABLE_NOTE
    with open(os.path.join(savedir, "metrics.json"), "w") as f:
        json.dump(payload, f, indent=4)
    return savedir
