"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named by a hash of its source,
of every header in ``csrc/`` and of the flags (a changed source or header
rebuilds, an unchanged one is reused), and loaded with ``ctypes``. A build
may add preprocessor ``defines`` (``("MXT_FWD_CUT=1",)``): an experiment's
variant, built and loaded beside the kernel, never instead of it. Every C
entry returns ``cudaGetLastError()`` and the Python wrapper raises when it
is not 0.

Nothing here runs at import: the CPU test suite imports every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from .base import MXNetError

__all__ = ["KERNEL_SOURCES", "build_all", "load", "build_dir"]

CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "conv_fused",
                  "batch_norm", "multi_tensor", "decode_attention",
                  "flash_attention_wide_wg", "flash_attention_wide_dkv",
                  "int8_conv", "box_nms")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "build" / "kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise MXNetError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                     "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _flags(defines: Tuple[str, ...] = ()) -> List[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _target(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _key(name: str, defines: Tuple[str, ...]) -> str:
    return f"{name}[{','.join(defines)}]" if defines else name


def build_all(names: List[str] = None,
              variants: Iterable[Tuple[str, Tuple[str, ...]]] = ()
              ) -> Dict[str, float]:
    """Compile every kernel that is not built yet, and each variant
    ``(name, defines)``, one ``nvcc`` per library, all started together.
    Returns seconds per name (``name[defines]`` for a variant; 0.0 when the
    library was already there); ``nvcc``'s output (``-Xptxas -v``:
    registers, shared memory, spills) lands beside each library as
    ``.log``. Raises if any build fails."""
    jobs = [(n, ()) for n in (KERNEL_SOURCES if names is None else names)]
    jobs += [(n, tuple(d)) for n, d in variants]
    build_dir().mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    with _LOCK:
        for name, defines in jobs:
            key = _key(name, defines)
            target = _target(name, defines)
            if target.exists():
                out[key] = 0.0
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[key] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, target, time.perf_counter())
        failed = []
        for name, (p, tmp, target, t0) in procs.items():
            log, _ = p.communicate()
            out[name] = time.perf_counter() - t0
            target.with_suffix(".log").write_text(log)
            if p.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, target)
    if failed:
        raise MXNetError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built with ``defines``),
    built first if needed."""
    key = _key(name, tuple(defines))
    lib = _LOADED.get(key)
    if lib is not None:
        return lib
    target = _target(name, tuple(defines))
    if not target.exists():
        build_all([], [(name, tuple(defines))])
    with _LOCK:
        lib = _LOADED.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(target))
            _LOADED[key] = lib
    return lib
