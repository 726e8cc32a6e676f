"""Experiment logging (port of ``swnerf_tpu/utils/logging.py``).

``args.txt`` / ``config.txt`` snapshots (reference run.py:531-540) and an
always-on ``metrics.jsonl`` of scalars and throughput. The JAX package also
writes TensorBoard through tensorboardX when it is installed; the port writes
``metrics.jsonl`` only and needs no tensorboardX. ``enable_debug_nans`` is
not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def snapshot_args(basedir: str, expname: str, args, config_path: Optional[str]) -> None:
    """Write args.txt (and a copy of the config file as config.txt)."""
    d = os.path.join(basedir, expname)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "args.txt"), "w") as f:
        for k in sorted(vars(args)):
            f.write(f"{k} = {getattr(args, k)}\n")
    if config_path is not None and os.path.exists(config_path):
        with open(config_path) as src, open(os.path.join(d, "config.txt"), "w") as f:
            f.write(src.read())


class ExperimentLogger:
    """Appends one JSON record per call to ``<basedir>/<expname>/metrics.jsonl``."""

    def __init__(self, basedir: str, expname: str):
        self.dir = os.path.join(basedir, expname)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._t_last = time.perf_counter()
        self._step_last: Optional[int] = None

    def scalars(self, step: int, values: Dict[str, Any]) -> None:
        rec = {"step": int(step), "t": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

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
        self._jsonl.close()
