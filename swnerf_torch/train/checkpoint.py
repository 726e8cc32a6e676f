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
entries.

``SWNERF_CKPT_FORMAT`` (:func:`ckpt_formats`) selects the formats a save
writes, as in the JAX package: ``tar`` (the default), ``native`` (the JAX
package's flax-msgpack snapshot, ``{i:06d}.msgpack``, read and written here
by the port's own codec, ``utils/msgpack.py``) or both. A native snapshot
holds the JAX package's TrainState in its state-dict form (JAX names,
``[in, out]`` weights, optax's ``scale_by_adam`` count / mu / nu), so either
package resumes the other's: :func:`params_to_jax` and the numpy Adam bridge
(:func:`adam_to_torch_dict`, :func:`torch_dict_to_adam`) translate it.
``orbax`` needs orbax and tensorstore, which the card's machine lacks: the
port refuses it (ROADMAP.md lists it as not ported).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from swnerf_torch.parallel.multihost import is_primary
from swnerf_torch.utils import msgpack


def _seq(layers) -> List[Any]:
    """A list of layers, or its state-dict form (``{"0": ..., "1": ...}``,
    as a native snapshot holds it), as a list."""
    return [layers[str(i)] for i in range(len(layers))] if isinstance(layers, Mapping) else list(layers)


def _vanilla_layers(tree: Mapping[str, Any]) -> Iterator[Tuple[str, Mapping[str, Any]]]:
    """(torch module name, layer) in the reference's ``parameters()`` order:
    pts_linears, views_linears, feature, alpha, rgb (or output)."""
    for i, lyr in enumerate(_seq(tree["pts_linears"])):
        yield f"pts_linears.{i}", lyr
    if "views_linears" in tree:
        for i, lyr in enumerate(_seq(tree["views_linears"])):
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
        # contiguous: torch's fused Adam needs its moments strided as their parameters
        sd[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(w.T if transpose else w))
        sd[f"{name}.bias"] = torch.tensor(b)
    return sd


def _tnerf_layers(tree: Mapping[str, Any]) -> Iterator[Tuple[str, Mapping[str, Any]]]:
    """(torch module name, layer) of a T-NeRF in the ``.tar``'s order: the
    reference wraps each Linear in a Sequential (``<name>.0``)."""
    for i, lyr in enumerate(_seq(tree["layers"])):
        yield f"layers.{i}.0", lyr
    for name in ("density", "feature", "layer_9", "color"):
        yield f"{name}.0", tree[name]


def _dnerf_layers(tree: Mapping[str, Any]) -> Iterator[Tuple[str, Mapping[str, Any]]]:
    """(torch module name, layer) of a DirectTemporalNeRF in the ``.tar``'s
    order (swnerf_tpu/train/checkpoint.py:60-68): ``_occ.*`` (the canonical
    trunk), ``_time.{i}``, ``_time_out``."""
    for name, lyr in _vanilla_layers(tree["canonical"]):
        yield f"_occ.{name}", lyr
    for i, lyr in enumerate(_seq(tree["time_net"]["layers"])):
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
    first, so the file loads on a machine without a card. Rank 0 only
    (``parallel/multihost.py``: every rank computes, the primary owns the
    files)."""
    if not is_primary():
        return

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
    """Latest-last checkpoints of an experiment: ``.tar``, native
    ``.msgpack`` and ``.orbax`` entries ordered by iteration NUMBER
    (``1000000`` after ``990000``), a ``.tar`` after its same-iteration
    siblings, unfinished ``.tmp`` writes left out (``find_checkpoints`` of
    the JAX package, train/checkpoint.py:497-524); ``ft_path`` names one
    file and wins (reference run.py:262-268)."""
    if ft_path is not None and ft_path != "None":
        return [ft_path]
    d = os.path.join(basedir, expname)
    if not os.path.isdir(d):
        return []
    names = [f for f in os.listdir(d) if f.endswith((".tar", ".msgpack", ".orbax"))]

    def key(f):
        stem = os.path.splitext(f)[0]
        numeric = stem.isdigit()
        return (int(stem) if numeric else 0, "" if numeric else stem, f.endswith(".tar"))

    return [os.path.join(d, f) for f in sorted(names, key=key)]


# ---------------------------------------------------------------- the format switch


def ckpt_formats() -> frozenset:
    """``SWNERF_CKPT_FORMAT`` as a validated set: a comma-list of ``tar``
    (the default: the reference's torch archive) and ``native`` (the JAX
    package's flax-msgpack snapshot); ``both`` = tar,native. ``orbax`` (and
    ``all``, which includes it) raises: the port does not write it."""
    v = os.environ.get("SWNERF_CKPT_FORMAT", "tar").lower()
    expanded = {"both": "tar,native", "all": "tar,native,orbax"}.get(v, v)
    fmts = frozenset(s.strip() for s in expanded.split(",") if s.strip())
    if not fmts or fmts - {"tar", "native", "orbax"}:
        raise ValueError(
            f"SWNERF_CKPT_FORMAT={v!r}: expected a comma-set of "
            "tar|native|orbax (aliases: both = tar,native; all = all three)"
        )
    if "orbax" in fmts:
        raise ValueError(f"SWNERF_CKPT_FORMAT={v!r}: the orbax format is not ported to swnerf_torch (it needs "
                         "orbax and tensorstore; see ROADMAP.md); use tar, native or both")
    return fmts


def native_path(tar_path: str) -> str:
    """``000123.tar`` -> ``000123.msgpack``."""
    base = tar_path[:-4] if tar_path.endswith(".tar") else tar_path
    return base + ".msgpack"


# ---------------------------------------------------------------- the JAX package's layout


def _layer(sd: Mapping[str, Any], mod: str) -> Dict[str, np.ndarray]:
    w, b = (sd[f"{mod}.{f}"] for f in ("weight", "bias"))
    w, b = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (w, b))
    return {"w": np.ascontiguousarray(w.T, dtype=np.float32), "b": np.array(b, dtype=np.float32)}


def _indexed(sd: Mapping[str, Any], prefix: str, suffix: str = "") -> List[Dict[str, np.ndarray]]:
    out = []
    while f"{prefix}.{len(out)}{suffix}.weight" in sd:
        out.append(_layer(sd, f"{prefix}.{len(out)}{suffix}"))
    return out


def _vanilla_tree(sd: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {"pts_linears": _indexed(sd, "pts_linears")}
    views = _indexed(sd, "views_linears")
    if views:
        tree["views_linears"] = views
        tree.update((name, _layer(sd, name)) for name in ("feature_linear", "alpha_linear", "rgb_linear"))
    else:
        tree["output_linear"] = _layer(sd, "output_linear")
    return tree


def params_to_jax(sd):
    """The port's state dict (``[out, in]``) -> the JAX package's param
    pytree (``[in, out]`` numpy leaves), the inverse of
    :func:`params_from_jax`: vanilla and D-NeRF ``original``, T-NeRF
    (``layers.{i}.0.*``) and D-NeRF ``direct_temporal`` (``_occ.*``). A
    list of state dicts (MultiRes levels) gives a list of trees."""
    if isinstance(sd, (list, tuple)):
        return [params_to_jax(s) for s in sd]
    if "_occ.pts_linears.0.weight" in sd:
        occ = {k[len("_occ."):]: v for k, v in sd.items() if k.startswith("_occ.")}
        return {"canonical": _vanilla_tree(occ),
                "time_net": {"layers": _indexed(sd, "_time"), "out": _layer(sd, "_time_out")}}
    if "layers.0.0.weight" in sd:
        tree = {"layers": _indexed(sd, "layers", ".0")}
        tree.update((name, _layer(sd, f"{name}.0")) for name in ("density", "feature", "layer_9", "color"))
        return tree
    return _vanilla_tree(sd)


def adam_to_torch_dict(adam: Mapping[str, Any], params: Mapping[str, Any], keys: Sequence[str] = ("coarse", "fine"),
                       lr: float = 5e-4) -> Dict[str, Any]:
    """optax ``scale_by_adam``'s state in its state-dict form (``{"count",
    "mu", "nu"}``, the moment trees keyed like ``params``) -> a torch Adam
    ``state_dict()`` over the ``keys``' parameters in the reference's
    ``grad_vars`` order (None skipped): ``exp_avg`` = mu, ``exp_avg_sq`` =
    nu (weights transposed to ``[out, in]``), ``step`` = count (the port's
    numpy copy of the JAX package's ``adam_to_torch_dict``,
    train/checkpoint.py:154)."""
    step = torch.tensor(float(int(adam["count"])))
    state: Dict[int, Any] = {}
    for key in keys:
        if params[key] is not None:
            mu, nu = params_from_jax(adam["mu"][key]), params_from_jax(adam["nu"][key])
            for name in mu:
                state[len(state)] = {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    group = {"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0, "amsgrad": False, "maximize": False,
             "foreach": None, "capturable": False, "differentiable": False, "fused": None,
             "params": list(range(len(state)))}
    return {"state": state, "param_groups": [group]}


def torch_dict_to_adam(torch_opt: Mapping[str, Any], params: Mapping[str, Any],
                       keys: Sequence[str] = ("coarse", "fine")) -> Dict[str, Any]:
    """A torch Adam ``state_dict()`` -> optax ``scale_by_adam``'s state in
    its state-dict form, ``{"count": int32 [], "mu", "nu"}`` keyed like
    ``params`` (None where ``params`` has None); a parameter Adam never
    updated has zero moments (the port's numpy copy of the JAX package's
    ``torch_dict_to_adam``, train/checkpoint.py:189)."""
    tstate = torch_opt["state"]
    step, idx = 0, 0
    out: Dict[str, Any] = {"mu": dict.fromkeys(params), "nu": dict.fromkeys(params)}
    for key in keys:
        if params[key] is None:
            continue
        mu, nu = {}, {}
        for name, p in params_from_jax(params[key]).items():
            ent = tstate.get(idx, tstate.get(str(idx)))
            idx += 1
            if ent is None:
                mu[name] = nu[name] = torch.zeros_like(p)
            else:
                mu[name], nu[name], step = ent["exp_avg"], ent["exp_avg_sq"], ent["step"]
        out["mu"][key], out["nu"][key] = params_to_jax(mu), params_to_jax(nu)
    out["count"] = np.array(int(torch.as_tensor(step).item()), np.int32)
    return out


def _state_dict_form(tree):
    """A pytree of dicts and lists with the lists as ``{"0": ..., "1": ...}``
    (flax's ``to_state_dict``, the layout a snapshot holds)."""
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict_form(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _state_dict_form(v) for k, v in tree.items()}
    return tree


def native_state(state) -> Dict[str, Any]:
    """A :class:`~swnerf_torch.train.loop.TrainState` (coarse and fine) as
    the JAX package's TrainState in its state-dict form: ``{"step",
    "params": {"coarse", "fine"}, "opt_state": {"0": scale_by_adam's
    state, "1": scale_by_learning_rate's {"count"}}}``."""
    params = {"coarse": params_to_jax(state.coarse.state_dict()),
              "fine": None if state.fine is None else params_to_jax(state.fine.state_dict())}
    adam = torch_dict_to_adam(state.optimizer.state_dict(), params)
    return _state_dict_form({"step": np.array(state.step, np.int32), "params": params,
                             "opt_state": {"0": adam, "1": {"count": adam["count"].copy()}}})


def restore_native_state(state, saved: Mapping[str, Any], step: Optional[int] = None) -> None:
    """The inverse of :func:`native_state`: weights into the models, mu /
    nu / count into torch Adam (the card's fused, capturable Adam too: the
    state's load hook moves each count to its parameter's device), and the
    TrainState's step (``step``, the resumed iteration, else the snapshot's
    own; MultiRes levels pass their Adam count)."""
    params = saved["params"]
    state.coarse.load_state_dict(params_from_jax(params["coarse"]))
    if state.fine is not None:
        state.fine.load_state_dict(params_from_jax(params["fine"]))
    opt = adam_to_torch_dict(saved["opt_state"]["0"], params)
    opt["param_groups"] = state.optimizer.state_dict()["param_groups"]
    state.optimizer.load_state_dict(opt)
    state.set_step(int(saved["step"]) if step is None else step)


def _check_compat(saved, template, path: str = "state") -> None:
    """Same keys and leaf shapes as ``template`` (the JAX package's
    ``_check_state_dict_compat``), else a ValueError naming the path."""
    if isinstance(template, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"native checkpoint mismatch at {path}: saved a leaf where the current model has a "
                             f"subtree {sorted(template)}")
        if set(saved) != set(template):
            raise ValueError(f"native checkpoint mismatch at {path}: saved keys {sorted(saved)} != current model "
                             f"keys {sorted(template)} (was the snapshot written with a different model config?)")
        for k in template:
            _check_compat(saved[k], template[k], f"{path}.{k}")
        return
    if isinstance(saved, dict):
        raise ValueError(f"native checkpoint mismatch at {path}: saved a subtree {sorted(saved)} where the current "
                         "model has a leaf")
    s_shape, t_shape = getattr(saved, "shape", None), getattr(template, "shape", None)
    if s_shape != t_shape:
        raise ValueError(f"native checkpoint mismatch at {path}: saved shape {s_shape} != current model shape "
                         f"{t_shape} (was the snapshot written with a different model config?)")


def save_native(path: str, state: Mapping[str, Any], extra: Optional[Dict[str, Any]] = None) -> None:
    """The native snapshot: ``{"state": state, "extra": extra}`` (state-dict
    form, numpy leaves) as flax-msgpack bytes, written to ``path + ".tmp"``
    and renamed into place. Rank 0 only, as :func:`save_tar`."""
    if not is_primary():
        return
    blob = msgpack.packb({"state": state, "extra": extra or {}})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def load_native(path: str, state_template: Mapping[str, Any], extra_template: Optional[Dict[str, Any]] = None):
    """Read a native snapshot, check it against the templates (state-dict
    form: the current model's keys and shapes) and return ``(state,
    extra)`` in state-dict form; a mismatch raises ValueError naming the
    file and the path inside it."""
    with open(path, "rb") as f:
        raw = msgpack.unpackb(f.read())
    try:
        _check_compat(raw, {"state": state_template, "extra": extra_template or {}}, "snapshot")
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return raw["state"], raw["extra"]


def try_native_resume(ckpts: List[str], no_reload: bool, make_template: Callable[[], Mapping[str, Any]]):
    """If the latest checkpoint is a native snapshot, read it against
    ``make_template()`` and return ``(state, start)``, the state in
    state-dict form; None otherwise (the ``.tar`` path follows). The
    newest being an ``.orbax`` raises: the port does not read it, and an
    older file is not the run's latest state."""
    if not ckpts or no_reload:
        return None
    last = ckpts[-1]
    if last.endswith(".orbax"):
        raise ValueError(f"{last}: the orbax format is not ported to swnerf_torch (see ROADMAP.md); resume from a "
                         ".tar or .msgpack of the run, or pass --no_reload")
    if last.endswith(".msgpack"):
        print("Reloading from", last)
        state, extra = load_native(last, make_template(), {"global_step": 0})
        return state, int(extra["global_step"])
    return None


def resume_checkpoint(basedir: str, expname: str, ft_path: Optional[str], no_reload: bool,
                      native_template: Callable[[], Mapping[str, Any]],
                      restore_native: Callable[[Mapping[str, Any], int], None],
                      restore_tar: Callable[[Dict[str, Any]], None]) -> int:
    """A trainer's start-up: validate ``SWNERF_CKPT_FORMAT`` (a typo, or
    ``orbax``, fails here, not at the first save), then restore the latest
    checkpoint, a native snapshot through ``restore_native(state, step)``
    or a ``.tar`` through ``restore_tar(ckpt)``. Returns the restored
    global step, 0 when nothing is restored."""
    ckpt_formats()
    ckpts = find_checkpoints(basedir, expname, ft_path)
    native = try_native_resume(ckpts, no_reload, native_template)
    if native is not None:
        restore_native(*native)
        return native[1]
    if ckpts and not no_reload:
        print("Reloading from", ckpts[-1])
        ckpt = load_tar(ckpts[-1])
        restore_tar(ckpt)
        return int(ckpt["global_step"])
    return 0


def save_checkpoint(basedir: str, expname: str, i: int, tar_payload: Callable[[], Dict[str, Any]],
                    native_state: Callable[[], Mapping[str, Any]]) -> str:
    """Write ``{i:06d}.tar`` from ``tar_payload()`` and/or the native
    ``{i:06d}.msgpack`` from ``native_state()``, as ``SWNERF_CKPT_FORMAT``
    selects; each builder runs (a copy to the host) only when its format
    is, and only on rank 0, which writes. Returns the ``.tar``'s path."""
    path = os.path.join(basedir, expname, f"{i:06d}.tar")
    fmts = ckpt_formats()
    if not is_primary():
        return path
    if "tar" in fmts:
        save_tar(path, tar_payload())
        print("Saved checkpoints at", path)
    if "native" in fmts:
        p = native_path(path)
        save_native(p, native_state(), extra={"global_step": i})
        print("Saved checkpoints at", p)
    return path
