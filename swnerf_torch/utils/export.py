"""The eval renderer as a self-contained artifact (port of
``swnerf_tpu/utils/export.py``), through ``torch.export``.

The exported callable has the JAX artifact's calling convention

    (params, origins, directions, viewdirs, near, far[, times]) ->
        (rgb, disp, acc, depth)

with a fixed ray-batch size (callers tile and pad, as ``render_image``
does; a call at another size raises). Rendering is ``render/core.py::
render_rays`` in the config's deterministic eval mode. ``params`` is an
input of the program, ``{"coarse": {name: tensor}, "fine": {name: tensor}
or None}`` under the fields' ``named_parameters()`` names, applied through
``torch.func.functional_call``: no weight is baked into the artifact.

Devices. ``torch.export`` bakes a factory call's device into the graph
(``render_rays`` makes its depths with ``torch.linspace(..., device=)``).
The artifact holds one program, traced on the CPU (on fake tensors: no
weight or ray enters it), and the platforms it was exported for, ``"cpu"``
and / or ``"cuda"``; ``load_renderer`` runs it on the inputs' device, moved
there by ``torch.export.passes.move_to_device_pass`` on first use. So a
``cpu,cuda`` artifact is written on a machine without a card and runs on
both. Nothing in the program depends on the device it was traced on: the
fields' routes are fixed when they are built, and a fused field's operand
type is its ``compute_dtype``.

Fused fields. A field on its kernel route (``fused``: B7, B7' or B8; B6 in
the D-NeRF field) calls the forward-only kernels through the PyTorch ops
``swnerf::trunk`` and ``swnerf::time_net`` (``ops/kernels/trunk.py``,
``time_net.py``), whose fakes give the shapes while tracing: the weights are
packed by torch ops on the ``params`` input inside the program, in the
field's ``compute_dtype`` (``export_model --export_fused`` sets the card's
operand type, bf16), and the ops launch the kernels on the card (their
plain twins, at that operand type, on the CPU). Such an artifact needs
``swnerf_torch`` importable where it is loaded (for the ops'
registrations), and a card for its ``cuda`` runs.

The resample. Every artifact with a fine pass, plain or fused, calls B2 as
the op ``swnerf::sample_pdf`` (``ops/kernels/sample_pdf.py``), as the JAX
artifact embeds its Pallas sample_pdf: B2 on the card, its twin on the
CPU. ``load_renderer`` imports the registrations of the ops an artifact
calls (its header's ``ops``); a plain artifact without a fine pass calls
none and needs nothing of the port.
"""

from __future__ import annotations

import copy
import io
import json
import struct
from typing import Dict, Optional, Sequence

import torch

MAGIC = b"swnerf_torch.export\n"
PLATFORMS = ("cpu", "cuda")


def kernel_ops(ep) -> Dict[str, int]:
    """The ``swnerf::`` ops an exported program calls, with their call
    counts."""
    out: Dict[str, int] = {}
    for node in ep.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("swnerf."):
            out[name] = out.get(name, 0) + 1
    return out


class _Render(torch.nn.Module):
    """The coarse field (and the fine one) and the eval render."""

    def __init__(self, field, fine_field, rcfg, with_times: bool):
        super().__init__()
        self.coarse = field
        self.fine = fine_field
        self.rcfg = rcfg.eval_mode()
        self.with_times = with_times

    def forward(self, origins, directions, viewdirs, near, far, times=None):
        from swnerf_torch.render.core import Rays, render_rays

        rays = Rays(origins, directions, viewdirs, near, far, times if self.with_times else None)
        out = render_rays(self.coarse, rays, self.rcfg, fine_model=self.fine)
        return out["rgb"], out["disp"], out["acc"], out["depth"]


class _Program(torch.nn.Module):
    """The exported root: the params input applied to the fields by
    ``functional_call``. The fields are held outside the module tree, so
    their own parameters never enter the program."""

    def __init__(self, render: _Render):
        super().__init__()
        object.__setattr__(self, "_render", render)

    def forward(self, params, origins, directions, viewdirs, near, far, *times):
        flat = {f"coarse.{k}": v for k, v in params["coarse"].items()}
        if params.get("fine") is not None:
            flat.update({f"fine.{k}": v for k, v in params["fine"].items()})
        return torch.func.functional_call(self._render, flat, (origins, directions, viewdirs, near, far, *times))


def field_takes_times(field) -> bool:
    """The time-conditioned fields (T-NeRF, D-NeRF ``direct_temporal``)
    read ``rays.times``."""
    from swnerf_torch.models import DirectTemporalNeRF, TNeRF

    return isinstance(field, (DirectTemporalNeRF, TNeRF))


def _fake_args(params, n_rays: int, with_times: bool):
    """The program's example inputs as fake CPU tensors of their shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def like(x):
        return torch.empty(tuple(x.shape), dtype=x.dtype)

    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = {k: None if v is None else {n: like(t) for n, t in v.items()} for k, v in params.items()}
        args = [fake, *(torch.empty((n_rays, 3)) for _ in range(3)), torch.empty((n_rays,)), torch.empty((n_rays,))]
        if with_times:
            args.append(torch.empty((n_rays, 1)))
    return tuple(args)


def export_renderer(
    field,
    params,
    rcfg,
    n_rays: int,
    fine_field=None,
    platforms: Optional[Sequence[str]] = None,
    with_times: Optional[bool] = None,
) -> bytes:
    """Serialize the eval renderer for ``field`` at a fixed ray-batch size.

    Args:
      field: the coarse field (``fused=False`` for a plain artifact; on the
        kernel route its kernels become op calls, module docstring).
      params: ``{"coarse": {name: tensor}, "fine": {...} or None}``; their
        shapes and dtypes are the artifact's input spec. Without
        ``fine_field``, fine params run the coarse field's architecture.
      rcfg: RenderConfig; exported in deterministic eval mode.
      n_rays: the artifact's ray-batch size.
      fine_field: an optional distinct fine field (``--netdepth_fine``).
      platforms: ``"cpu"`` and / or ``"cuda"``; default the device of the
        params.
      with_times: the artifact takes a trailing ``times [n_rays, 1]``.
        Default: whether the field is time-conditioned.

    Returns: the artifact's bytes (a header and the ``torch.export``
    program).
    """
    if with_times is None:
        with_times = field_takes_times(field)
    first = next(iter(params["coarse"].values()))
    platforms = [first.device.type] if platforms is None else list(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"export platforms {platforms}: each must be one of {PLATFORMS}")
    if fine_field is None and params.get("fine") is not None:
        fine_field = copy.deepcopy(field)  # the coarse architecture, run on the fine params
    program = _Program(_Render(field, fine_field, rcfg, with_times))
    with torch.no_grad():
        ep = torch.export.export(program, _fake_args(params, n_rays, with_times))
    ep.example_inputs = None  # fake tensors: nothing to keep
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    ops = sorted(kernel_ops(ep))
    header = json.dumps({"platforms": platforms, "n_rays": int(n_rays), "with_times": bool(with_times),
                         "fused": any(op != "swnerf.sample_pdf.default" for op in ops), "ops": ops}).encode()
    return MAGIC + struct.pack("<Q", len(header)) + header + buf.getvalue()


class LoadedRenderer:
    """An artifact's callable: ``(params, origins, directions, viewdirs,
    near, far[, times]) -> (rgb, disp, acc, depth)`` on the inputs' device,
    without autograd."""

    def __init__(self, blob: bytes):
        if not blob.startswith(MAGIC):
            raise ValueError("not a swnerf_torch export artifact")
        (n,) = struct.unpack_from("<Q", blob, len(MAGIC))
        start = len(MAGIC) + 8
        self.meta = json.loads(blob[start : start + n])
        if self.meta["ops"]:  # the swnerf:: ops' registrations
            import swnerf_torch.ops.kernels.sample_pdf  # noqa: F401
            import swnerf_torch.ops.kernels.time_net  # noqa: F401
            import swnerf_torch.ops.kernels.trunk  # noqa: F401
        self._program = blob[start + n :]
        self._programs: Dict[str, torch.export.ExportedProgram] = {}
        self._modules: Dict[str, torch.nn.Module] = {}

    @property
    def n_rays(self) -> int:
        return self.meta["n_rays"]

    def program(self, platform: str) -> torch.export.ExportedProgram:
        """The exported program on ``platform`` (loaded on first use; on a
        card a copy of its own, moved there: the pass moves the program it
        is given)."""
        if platform not in self.meta["platforms"]:
            raise ValueError(f"the artifact was exported for {self.meta['platforms']}, not {platform!r}")
        if platform not in self._programs:
            ep = torch.export.load(io.BytesIO(self._program))
            if platform != "cpu":
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, platform)
            self._programs[platform] = ep
        return self._programs[platform]

    def __call__(self, params, origins, directions, viewdirs, near, far, *times):
        if origins.shape[0] != self.n_rays:
            raise ValueError(f"the artifact renders batches of {self.n_rays} rays, not {origins.shape[0]}")
        if len(times) != int(self.meta["with_times"]):
            raise ValueError(f"the artifact takes {'a' if self.meta['with_times'] else 'no'} times operand")
        platform = origins.device.type
        if platform not in self._modules:
            self._modules[platform] = self.program(platform).module()
        with torch.no_grad():
            return tuple(self._modules[platform](params, origins, directions, viewdirs, near, far, *times))


def load_renderer(blob: bytes) -> LoadedRenderer:
    """Deserialize an :func:`export_renderer` artifact into a callable with
    the exported signature."""
    return LoadedRenderer(blob)
