"""Export a (trained) checkpoint's eval renderer as a serving artifact
(port of ``swnerf_tpu/pipelines/export_model.py``).

The reference ships the repo and the ``.tar`` and rebuilds the model in
Python (nerf/load_model.py:127-149); this pipeline writes the deterministic
eval renderer as a ``torch.export`` program (``utils/export.py``) beside the
checkpoint: serving needs ``load_renderer(blob)`` and the params.

Usage (the trainer's flag set selects config and checkpoint; the export
flags are taken out before the trainer's parser sees the argv):

    python -m swnerf_torch.pipelines.export_model --config configs/lego.txt \\
        --export_out logs/lego/renderer.pt2 --export_rays 8192 \\
        [--export_mode nerf|dnerf|tnerf|multires] [--export_platforms cpu,cuda] [--export_fused]

``--export_mode`` picks the checkpoint family: ``nerf`` (the vanilla flag
set), ``dnerf`` / ``tnerf`` (the dynamic flag set; time-conditioned artifacts
take a trailing ``times [n, 1]``), or ``multires`` (the dynamic flag set;
one artifact per pyramid level at ``<export_out>.L<layer>``, whose frame
geometry is printed: serving renders each level's frame and reconstructs
with ``ops/pyramid.py``). ``--export_rays`` fixes the ray-batch size.
``--export_platforms`` lists the devices the artifact runs on (default: the
``--device`` the checkpoint is loaded on).

Fields are rebuilt ``fused=False`` by default: the plain route, no field
kernel (a fine pass's resample calls B2, ``swnerf::sample_pdf``, either way).
``--export_fused`` rebuilds them on the kernel route at the card's operand
type (``switches.operand_dtype``: bf16), so the artifact calls B7, B7' or B8
and B6 as the ops ``swnerf::trunk`` and ``swnerf::time_net``; a field that
no op covers raises, naming it, rather than exporting the plain route.
"""

from __future__ import annotations

import argparse
import time

import torch


def on_kernel_route(field) -> bool:
    """Whether every network of ``field`` runs a kernel that an op covers:
    B7 / B8 (``VanillaNeRF.fused``, ``NeRFOriginal`` too), B7'
    (``TNeRF.fused``), B6 and B7 (``DirectTemporalNeRF``)."""
    from swnerf_torch.models import DirectTemporalNeRF

    if isinstance(field, DirectTemporalNeRF):
        return bool(field.fused_time and field.fused_trunk)
    return bool(getattr(field, "fused", False))


def export_fields(field, fine, fused: bool, device):
    """The fields rebuilt on the export's route, with the loaded fields' weights:
    the plain route, or (``fused``) the kernel route at the card's operand
    type, refused where no op covers a network."""
    from swnerf_torch.utils.switches import operand_dtype

    dtype = operand_dtype(torch.device("cuda")) if fused else None
    out = []
    for name, f in (("coarse", field), ("fine", fine)):
        if f is None:
            out.append(None)
            continue
        g = type(f)(f.cfg, device=device, fused=fused, compute_dtype=dtype)
        g.load_state_dict(f.state_dict())
        g.eval()
        if fused and not on_kernel_route(g):
            raise ValueError(f"--export_fused: no kernel op covers the {name} field ({type(f).__name__}, {f.cfg})")
        out.append(g)
    return out


def _params(*fields):
    """``{"coarse": ..., "fine": ...}`` from the fields' parameters."""
    return {k: None if f is None else {n: p.detach() for n, p in f.named_parameters()}
            for k, f in zip(("coarse", "fine"), fields)}


def _load(mode, rest, fused):
    """(field, fine_field, rcfg, params, start, with_times, device) for the mode."""
    from swnerf_torch.device import resolve_device
    from swnerf_torch.utils.config import config_parser, config_parser_dnerf

    if mode == "nerf":
        from swnerf_torch.pipelines.run_nerf import create_vanilla

        args = config_parser().parse_args(rest)
        device = resolve_device(args.device)
        state, rcfg, _eval_pass, _cfgs = create_vanilla(args, device)
        with_times = False
    elif mode == "dnerf":
        from swnerf_torch.pipelines.run_dnerf import create_dnerf

        args = config_parser_dnerf().parse_args(rest)
        device = resolve_device(args.device)
        state, rcfg, _eval_pass, _cfgs = create_dnerf(args, device)
        # NeRFOriginal ignores the times; DirectTemporalNeRF reads them.
        with_times = args.nerf_type == "direct_temporal"
    elif mode == "tnerf":
        from swnerf_torch.pipelines.run_tnerf import create_tnerf

        args = config_parser_dnerf().parse_args(rest)
        device = resolve_device(args.device)
        state, rcfg, _eval_pass, _cfg = create_tnerf(args, device)
        with_times = True
    else:
        raise ValueError(f"--export_mode {mode!r} not recognized")
    field, fine = export_fields(state.coarse, state.fine, fused, device)
    return field, fine, rcfg, _params(field, fine), state.step, with_times, device


def _platforms(own, device):
    return own.export_platforms.split(",") if own.export_platforms else [device.type]


def _export_multires(own, rest):
    """One artifact per pyramid level: each level is its own D-NeRF-family
    field with its own channel widths (reference multires_dnerf.py:242-346);
    the level's frame geometry is printed so the server knows how to tile
    and reconstruct."""
    from swnerf_torch.device import resolve_device
    from swnerf_torch.pipelines.common import load_scene
    from swnerf_torch.pipelines.run_multires import create_multires
    from swnerf_torch.utils.config import config_parser_dnerf
    from swnerf_torch.utils.export import export_renderer

    args = config_parser_dnerf().parse_args(rest)
    device = resolve_device(args.device)
    kind, states, pyr_hwf, rcfg, start = create_multires(args, load_scene(args), device)
    paths = []
    for layer, st in enumerate(states):
        field, fine = export_fields(st.coarse, st.fine, own.export_fused, device)
        blob = export_renderer(field, _params(field, fine), rcfg, own.export_rays, fine_field=fine,
                               platforms=_platforms(own, device), with_times=kind == "direct_temporal")
        path = f"{own.export_out}.L{layer}"
        with open(path, "wb") as f:
            f.write(blob)
        h, w, focal = pyr_hwf[layer]
        print(f"Exported multires level {layer} @ iter {start} -> {path} ({len(blob)} bytes, {own.export_rays} rays, "
              f"level frame {h}x{w} focal={focal:.2f})")
        paths.append(path)
    return paths


def main(argv=None):
    from swnerf_torch.utils.export import export_renderer

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--export_out", required=True)
    ap.add_argument("--export_rays", type=int, default=8192)
    ap.add_argument("--export_mode", default="nerf", choices=("nerf", "dnerf", "tnerf", "multires"))
    ap.add_argument("--export_platforms", default=None, help="comma-separated devices, e.g. cpu,cuda")
    ap.add_argument("--export_fused", action="store_true")
    own, rest = ap.parse_known_args(argv)

    if own.export_mode == "multires":
        return _export_multires(own, rest)

    field, fine, rcfg, params, start, with_times, device = _load(own.export_mode, rest, own.export_fused)
    t0 = time.perf_counter()
    blob = export_renderer(field, params, rcfg, own.export_rays, fine_field=fine,
                           platforms=_platforms(own, device), with_times=with_times)
    secs = time.perf_counter() - t0
    with open(own.export_out, "wb") as f:
        f.write(blob)
    print(
        f"Exported {own.export_mode} @ iter {start} -> {own.export_out} in {secs:.2f} s "
        f"({len(blob)} bytes, {own.export_rays} rays"
        f"{', times operand' if with_times else ''}"
        f"{', platforms ' + own.export_platforms if own.export_platforms else ''}"
        f"{', fused' if own.export_fused else ''})"
    )
    return own.export_out


if __name__ == "__main__":
    main()
