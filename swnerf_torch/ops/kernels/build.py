"""Build the CUDA sources of ``swnerf_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface. ``nvcc`` compiles it
straight into ``swnerf_torch/_build/<name>-<hash>/lib<name>.so`` (no
PyTorch headers, no ninja), and :func:`load` opens it with ``ctypes``. The
directory is keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Sources build in parallel, one
``nvcc`` each. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_ROOT = Path(__file__).resolve().parents[2]
CSRC = PKG_ROOT / "csrc"
BUILD_ROOT = PKG_ROOT / "_build"
SOURCES = ("sample_pdf", "render_pass", "render_loss", "time_net", "trunk")
# No --use_fast_math: __sinf/__cosf are badly wrong at the 2^9-frequency
# encoding arguments (~2000 rad), and fast math may reassociate the
# transmittance floor max(1 - alpha + 1e-10, 1e-10).
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA toolkit's ``nvcc``, found as PyTorch's own builder finds it."""
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _key(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / f"{name}-{_key(name)}" / f"lib{name}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all at once.

    Returns name -> library path. The compiler's report (registers, shared
    memory, spills from ``-Xptxas -v``) is kept beside each library as
    ``build.log``.
    """
    names = list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        lib = out[n]
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out[n].parent / "build.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[n])  # atomic: concurrent builders never see a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and open ``lib<name>.so``."""
    return ctypes.CDLL(str(build([name])[name]))


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        lib.swnerf_error_string.restype = ctypes.c_char_p
        lib.swnerf_error_string.argtypes = [ctypes.c_int]
        msg = lib.swnerf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
