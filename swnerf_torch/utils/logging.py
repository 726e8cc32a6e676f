"""Experiment logging (port of ``swnerf_tpu/utils/logging.py``).

``args.txt`` / ``config.txt`` snapshots (reference run.py:531-540), an
always-on ``metrics.jsonl`` of scalars and throughput, and, where
tensorboardX imports, TensorBoard scalars and images at
``<basedir>/summaries/<expname>`` (the reference's d_nerf SummaryWriter);
without tensorboardX (the card's machine has none) only ``metrics.jsonl`` is
written, as in the JAX package. In a run of several processes rank 0 owns
these files (``parallel/multihost.py::is_primary``); the others write none.

:func:`enable_debug_nans` is the port's ``SWNERF_DEBUG_NANS`` (the JAX
package turns on ``jax_debug_nans``, which checks each dispatch's outputs):
a :class:`DebugNans` records each step's loss on the device, inside a
captured CUDA graph too, and after each dispatch checks the chunk's losses
and the parameters with one device reduction and one host read, raising
``FloatingPointError`` on a non-finite value.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from swnerf_torch.parallel.multihost import is_primary


def snapshot_args(basedir: str, expname: str, args, config_path: Optional[str]) -> None:
    """Write args.txt (and a copy of the config file as config.txt); rank 0
    only."""
    if not is_primary():
        return
    d = os.path.join(basedir, expname)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "args.txt"), "w") as f:
        for k in sorted(vars(args)):
            f.write(f"{k} = {getattr(args, k)}\n")
    if config_path is not None and os.path.exists(config_path):
        with open(config_path) as src, open(os.path.join(d, "config.txt"), "w") as f:
            f.write(src.read())


class ExperimentLogger:
    """Appends one JSON record per call to ``<basedir>/<expname>/metrics.jsonl``
    and, where tensorboardX imports, writes the same scalars and
    :meth:`image` to TensorBoard; on ranks other than 0 it writes nothing
    (``tb`` is None there)."""

    def __init__(self, basedir: str, expname: str):
        self.dir = os.path.join(basedir, expname)
        self._jsonl = None
        self.tb = None
        self._t_last = time.perf_counter()
        self._step_last: Optional[int] = None
        if not is_primary():
            return
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            self.tb = SummaryWriter(os.path.join(basedir, "summaries", expname))

    def scalars(self, step: int, values: Dict[str, Any]) -> None:
        rec = {"step": int(step), "t": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(k, float(v), int(step))

    def image(self, step: int, tag: str, img01) -> None:
        """An HxW or HxWxC image in [0, 1] to TensorBoard (nothing without it)."""
        if self.tb is not None:
            img = np.asarray(img01)
            if img.ndim == 2:
                img = img[..., None]
            self.tb.add_image(tag, np.clip(img, 0, 1), int(step), dataformats="HWC")

    def throughput(self, step: int, samples_per_step: int) -> Dict[str, float]:
        """steps/sec and ray-samples/sec (one device) since the last call.
        The caller synchronizes the device first, so the window is device
        time."""
        now = time.perf_counter()
        if self._step_last is None:
            self._step_last, self._t_last = step, now
            return {}
        dsteps = step - self._step_last
        dt = max(now - self._t_last, 1e-9)
        self._step_last, self._t_last = step, now
        sps = dsteps / dt
        out = {"steps_per_sec": sps, "ray_samples_per_sec_per_chip": sps * samples_per_step}
        self.scalars(step, out)
        return out

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self.tb is not None:
            self.tb.close()


class DebugNans:
    """``SWNERF_DEBUG_NANS=1``: :meth:`wrap` a train step so that it also
    writes its loss (``total_loss``, else ``loss``) into slot ``n`` of a
    device buffer and advances ``n`` there (elementwise ops: no host
    synchronization, so a step captured in a CUDA graph keeps them and each
    replay fills the next slot). Call :meth:`begin` before a
    dispatch of ``k`` steps and :meth:`check` after it: one ``isfinite``
    reduction over the chunk's losses and every parameter, one host read,
    and a ``FloatingPointError`` naming the first iteration whose loss is
    not finite, or the chunk where only a parameter is not."""

    def __init__(self, params: List[torch.Tensor], k_max: int):
        self.params = list(params)
        dev = self.params[0].device
        self.losses = torch.zeros(max(1, k_max), dtype=torch.float32, device=dev)
        self._slots = torch.arange(len(self.losses), device=dev)
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.first, self.k = 0, 0

    def wrap(self, train_step: Callable) -> Callable:
        def step(*args, **kwargs):
            metrics = train_step(*args, **kwargs)
            loss = metrics["total_loss"] if "total_loss" in metrics else metrics["loss"]
            self.losses.copy_(torch.where(self._slots == self.slot, loss.detach().float(), self.losses))
            self.slot.add_(1)
            return metrics

        return step

    def begin(self, first: int, k: int) -> None:
        """Before a dispatch of iterations ``first .. first + k - 1``."""
        if k > len(self.losses):
            raise ValueError(f"SWNERF_DEBUG_NANS: a chunk of {k} steps exceeds the {len(self.losses)} slots")
        self.first, self.k = first, k
        self.slot.zero_()

    @torch.no_grad()
    def check(self) -> None:
        """After the dispatch: raise ``FloatingPointError`` on a non-finite
        loss or parameter."""
        flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        ok = torch.cat([torch.isfinite(self.losses[: self.k]), torch.isfinite(flat).all().reshape(1)]).cpu()
        if bool(ok.all()):
            return
        bad = [j for j in range(self.k) if not ok[j]]
        last = self.first + self.k - 1
        if bad:
            raise FloatingPointError(f"SWNERF_DEBUG_NANS: non-finite loss at iteration {self.first + bad[0]} "
                                     f"(the dispatch of iterations {self.first}-{last})")
        raise FloatingPointError(f"SWNERF_DEBUG_NANS: a non-finite parameter after the dispatch of iterations "
                                 f"{self.first}-{last}")


def enable_debug_nans(params, k_max: int) -> DebugNans:
    """The port's ``enable_debug_nans`` (the JAX package sets
    ``jax_debug_nans``): a :class:`DebugNans` over ``params`` for
    dispatches of up to ``k_max`` steps, which the trainer wraps its steps
    in and checks after each dispatch."""
    return DebugNans(params, k_max)
