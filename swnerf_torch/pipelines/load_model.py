"""Standalone checkpoint loader for downstream tools (port of
``swnerf_tpu/pipelines/load_model.py``).

The reference keeps a dedicated ``nerf/load_model.py`` (config_parser ->
create_nerf -> latest ``*.tar`` in logs/<exp>/ -> model + query fn,
load_model.py:127-149). Here the same surface wraps
``run_nerf.create_vanilla`` (which already resumes) and returns a
point-query function on ``[N, 3]`` inputs, the shape the mesh extractor
uses (load_model.py:56-74). The field it queries is built with
``fused=None``: on a card it runs kernel B7 (B8 under
``SWNERF_FUSED_RAW=1``), on the CPU the plain trunk.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from swnerf_torch.device import resolve_device
from swnerf_torch.utils.config import config_parser


def load_model(argv=None, device: Optional[Union[str, torch.device]] = None):
    """Returns (model, state, args, query_fn).

    ``model`` is the fine field when there is one (the reference queries
    model_fine, extract_mesh.py:176), else the coarse; ``device`` defaults to
    the CLI's ``--device``. ``query_fn(positions [N, 3], viewdirs [N, 3]) ->
    raw [N, 4]`` (numpy or torch in, a torch tensor on the device out, no
    autograd).
    """
    from swnerf_torch.pipelines.run_nerf import create_vanilla

    args = config_parser().parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    state, _rcfg, _eval_pass, _cfgs = create_vanilla(args, dev)
    model = state.fine if state.fine is not None else state.coarse

    @torch.no_grad()
    def query_fn(positions, viewdirs) -> torch.Tensor:
        pts = torch.as_tensor(np.asarray(positions, np.float32) if not torch.is_tensor(positions) else positions,
                              dtype=torch.float32, device=dev)
        vd = torch.as_tensor(np.asarray(viewdirs, np.float32) if not torch.is_tensor(viewdirs) else viewdirs,
                             dtype=torch.float32, device=dev)
        return model(pts[:, None, :], vd)[:, 0, :]

    return model, state, args, query_fn
