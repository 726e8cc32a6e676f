"""Checkpoints, vanilla, T-NeRF, D-NeRF and MultiRes ``.tar`` schemas
(port of ``swnerf_tpu/train/checkpoint.py``).

The vanilla schema is the reference's ``{global_step,
network_fn_state_dict, network_fine_state_dict, optimizer_state_dict}``;
T-NeRF's has no fine dict (run_tnerf.py:719-728); D-NeRF's has one only
when two models are trained (run_dnerf.py:757-769); MultiRes keeps one
D-NeRF entry per pyramid level, ``network_fn_{l}``, ``network_fine_{l}``
(two models) and ``optimizer_{l}`` (swnerf_tpu/pipelines/run_multires.py:
180-223; written by ``pipelines/run_multires.py::save_multires_ckpt``). Weights are in torch
``[out, in]`` layout, so the port's modules load them as they are. The JAX
package keeps ``[in, out]`` pytrees; :func:`params_from_jax` is the weight
bridge that gives both packages identical weights.

The optimizer state is torch Adam's own ``state_dict()``: ``VanillaNeRF``,
``TNeRF`` and ``DirectTemporalNeRF`` register their layers in the
reference's ``parameters()`` order (the JAX package's ``model_layout``; a
two-model D-NeRF run lists the coarse model's, then the fine model's), so
the JAX package's Adam bridge
(``adam_to_torch_dict``/``torch_dict_to_adam``) reads and writes the same
entries. Only the native and orbax formats of the JAX package are not
ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch


def _vanilla_layers(tree: Mapping[str, Any]) -> Iterator[Tuple[str, Mapping[str, Any]]]:
    """(torch module name, layer) in the reference's ``parameters()`` order:
    pts_linears, views_linears, feature, alpha, rgb (or output)."""
    for i, lyr in enumerate(tree["pts_linears"]):
        yield f"pts_linears.{i}", lyr
    if "views_linears" in tree:
        for i, lyr in enumerate(tree["views_linears"]):
            yield f"views_linears.{i}", lyr
        for name in ("feature_linear", "alpha_linear", "rgb_linear"):
            yield name, tree[name]
    else:
        yield "output_linear", tree["output_linear"]


def _state_dict(layers: Iterator[Tuple[str, Mapping[str, Any]]], transpose: bool) -> Dict[str, torch.Tensor]:
    sd = {}
    for name, lyr in layers:
        w = np.asarray(lyr["weight"] if "weight" in lyr else lyr["w"], dtype=np.float32)
        b = np.asarray(lyr["bias"] if "bias" in lyr else lyr["b"], dtype=np.float32)
        sd[f"{name}.weight"] = torch.tensor(w.T if transpose else w)
        sd[f"{name}.bias"] = torch.tensor(b)
    return sd


def _tnerf_layers(tree: Mapping[str, Any]) -> Iterator[Tuple[str, Mapping[str, Any]]]:
    """(torch module name, layer) of a T-NeRF in the ``.tar``'s order: the
    reference wraps each Linear in a Sequential (``<name>.0``)."""
    for i, lyr in enumerate(tree["layers"]):
        yield f"layers.{i}.0", lyr
    for name in ("density", "feature", "layer_9", "color"):
        yield f"{name}.0", tree[name]


def _dnerf_layers(tree: Mapping[str, Any]) -> Iterator[Tuple[str, Mapping[str, Any]]]:
    """(torch module name, layer) of a DirectTemporalNeRF in the ``.tar``'s
    order (swnerf_tpu/train/checkpoint.py:60-68): ``_occ.*`` (the canonical
    trunk), ``_time.{i}``, ``_time_out``."""
    for name, lyr in _vanilla_layers(tree["canonical"]):
        yield f"_occ.{name}", lyr
    for i, lyr in enumerate(tree["time_net"]["layers"]):
        yield f"_time.{i}", lyr
    yield "_time_out", tree["time_net"]["out"]


def params_from_jax(tree):
    """A JAX param pytree (numpy leaves) -> the port's state dict in
    ``[out, in]`` layout: vanilla (and D-NeRF ``original``)
    ``{"pts_linears": [{"w": [in, out], "b"}], "feature_linear": ...}``,
    T-NeRF ``{"layers": [...], "density", "feature", "layer_9", "color"}``
    or D-NeRF ``direct_temporal`` ``{"canonical", "time_net"}``. A list of
    trees (MultiRes: one per pyramid level) gives a list of state dicts."""
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(t) for t in tree]
    if "canonical" in tree:
        layers = _dnerf_layers(tree)
    elif "layers" in tree:
        layers = _tnerf_layers(tree)
    else:
        layers = _vanilla_layers(tree)
    return _state_dict(layers, transpose=True)


def tnerf_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``.tar``'s T-NeRF state dict -> the port's: the same keys
    (``layers.{i}.0.*``, ``density.0.*``, ...), as float32 tensors."""
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()}


# A D-NeRF .tar's state dict also loads under its own keys (``_occ.*``,
# ``_time.{i}.*``, ``_time_out.*`` for ``direct_temporal``; the vanilla keys
# for ``original``), as float32 tensors.
dnerf_state_dict = tnerf_state_dict


def vanilla_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``.tar``'s vanilla state dict (already ``[out, in]``) -> the port's
    state dict: same walk as :func:`params_from_jax`, without the transpose."""
    tree: Dict[str, Any] = {"pts_linears": [], "views_linears": []}
    for key in sd:
        mod, _, field = key.rpartition(".")
        head, _, idx = mod.partition(".")
        if head in ("pts_linears", "views_linears"):
            layers = tree[head]
            while len(layers) <= int(idx):
                layers.append({})
            layers[int(idx)][field] = sd[key]
        else:
            tree.setdefault(mod, {})[field] = sd[key]
    if not tree["views_linears"]:
        del tree["views_linears"]
    return _state_dict(_vanilla_layers(tree), transpose=False)


def save_tar(path: str, payload: Mapping[str, Any]) -> None:
    """``torch.save`` a checkpoint payload; tensors are moved to the CPU
    first, so the file loads on a machine without a card."""

    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cpu(v) for v in x)
        return x

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(cpu(dict(payload)), tmp)
    os.replace(tmp, path)


def load_tar(path: str) -> Dict[str, Any]:
    """Load a ``.tar`` checkpoint onto the CPU (tensors only, no pickled code)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def find_checkpoints(basedir: str, expname: str, ft_path: Optional[str] = None) -> List[str]:
    """Latest-last ``.tar`` checkpoints of an experiment, ordered by
    iteration number; ``ft_path`` names one file and wins (reference
    run.py:262-268)."""
    if ft_path is not None and ft_path != "None":
        return [ft_path]
    d = os.path.join(basedir, expname)
    if not os.path.isdir(d):
        return []
    names = [f for f in os.listdir(d) if f.endswith(".tar")]

    def key(f):
        stem = os.path.splitext(f)[0]
        return (int(stem) if stem.isdigit() else -1, stem)

    return [os.path.join(d, f) for f in sorted(names, key=key)]
