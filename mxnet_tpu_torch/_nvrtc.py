"""NVRTC and the CUDA driver through ``ctypes``: compile CUDA C++ source to
a CUBIN for Hopper at run time, load it and launch its kernels.

The port's counterpart of Pallas's compile step, used by ``rtc.py``. Two
libraries: the toolkit's ``libnvrtc.so`` (``nvrtcCreateProgram``,
``nvrtcAddNameExpression``, ``nvrtcCompileProgram`` with
``--gpu-architecture=sm_90a -std=c++17``, ``nvrtcGetLoweredName``,
``nvrtcGetCUBIN``, ``nvrtcGetProgramLog``) and the driver's
``libcuda.so.1`` (``cuModuleLoadData``, ``cuModuleGetFunction``,
``cuFuncSetAttribute``, ``cuLaunchKernel``, ``cuGetErrorName``).

Nothing loads at import: the CPU test suite imports every module on a
machine without CUDA. ``libnvrtc`` is looked for in ``$CUDA_HOME/lib64``,
then ``/usr/local/cuda/lib64``, then the copy the torch wheel bundles under
``site-packages/nvidia/cuda_nvrtc/lib``; its ``libnvrtc-builtins`` is loaded
from the same directory first. A missing library raises
:class:`MXNetError` naming the paths tried.

The driver calls need a current context on the calling thread. Torch works
in each device's primary context, but makes it current only on threads
that have touched the CUDA runtime, so every load and launch here retains
the primary context (once per device) and pushes it around the call: a
launch from a fresh thread (a server's worker) works like one from the
main thread.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading
from contextlib import contextmanager
from typing import Dict, List, Sequence, Tuple

from .base import MXNetError

__all__ = ["compile_cubin", "nvrtc_version", "driver_version", "load_module",
           "get_function", "set_max_dynamic_shared", "launch",
           "include_dirs"]

ARCH = "sm_90a"
# CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
_ATTR_MAX_DYNAMIC_SHARED = 8

_LOCK = threading.RLock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_PRIMARY: Dict[int, ctypes.c_void_p] = {}


def _site_packages() -> List[str]:
    import site
    dirs = list(site.getsitepackages())
    user = site.getusersitepackages()
    return dirs + ([user] if isinstance(user, str) else [])


def _cuda_homes() -> List[str]:
    homes = []
    if os.environ.get("CUDA_HOME"):
        homes.append(os.environ["CUDA_HOME"])
    homes.append("/usr/local/cuda")
    return list(dict.fromkeys(homes))


def _nvrtc_dirs() -> List[str]:
    return ([os.path.join(h, "lib64") for h in _cuda_homes()]
            + [os.path.join(sp, "nvidia", "cuda_nvrtc", "lib")
               for sp in _site_packages()])


def include_dirs() -> List[str]:
    """Directories holding ``cuda_fp16.h`` / ``cuda_bf16.h`` for ``-I``."""
    cands = ([os.path.join(h, "include") for h in _cuda_homes()]
             + [os.path.join(sp, "nvidia", sub, "include")
                for sp in _site_packages()
                for sub in ("cuda_runtime", "cuda_nvrtc")])
    return [d for d in cands
            if os.path.isfile(os.path.join(d, "cuda_fp16.h"))]


def _nvrtc() -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get("nvrtc")
        if lib is not None:
            return lib
        tried = []
        for d in _nvrtc_dirs():
            tried.append(d)
            found = sorted(glob.glob(os.path.join(d, "libnvrtc.so*")))
            if not found:
                continue
            for builtins in sorted(glob.glob(
                    os.path.join(d, "libnvrtc-builtins.so*"))):
                ctypes.CDLL(builtins, mode=ctypes.RTLD_GLOBAL)
            lib = ctypes.CDLL(found[0], mode=ctypes.RTLD_GLOBAL)
            break
        if lib is None:
            raise MXNetError("NVRTC (libnvrtc.so) not found; looked in "
                             + ", ".join(tried))
        p, c, i, sz = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                       ctypes.c_size_t)
        sig = {
            "nvrtcVersion": [ctypes.POINTER(i), ctypes.POINTER(i)],
            "nvrtcCreateProgram": [ctypes.POINTER(p), c, c, i,
                                   ctypes.POINTER(c), ctypes.POINTER(c)],
            "nvrtcAddNameExpression": [p, c],
            "nvrtcCompileProgram": [p, i, ctypes.POINTER(c)],
            "nvrtcGetProgramLogSize": [p, ctypes.POINTER(sz)],
            "nvrtcGetProgramLog": [p, c],
            "nvrtcGetCUBINSize": [p, ctypes.POINTER(sz)],
            "nvrtcGetCUBIN": [p, c],
            "nvrtcGetLoweredName": [p, c, ctypes.POINTER(c)],
            "nvrtcDestroyProgram": [ctypes.POINTER(p)],
            "nvrtcGetErrorString": [i],
        }
        for name, args in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = c if name == "nvrtcGetErrorString" else i
        _LIBS["nvrtc"] = lib
        return lib


def _cuda() -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get("cuda")
        if lib is not None:
            return lib
        try:
            lib = ctypes.CDLL("libcuda.so.1", mode=ctypes.RTLD_GLOBAL)
        except OSError as e:
            raise MXNetError(f"the CUDA driver (libcuda.so.1) is not "
                             f"loadable: {e}") from None
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        sig = {
            "cuInit": [u],
            "cuDriverGetVersion": [ctypes.POINTER(i)],
            "cuDeviceGet": [ctypes.POINTER(i), i],
            "cuDevicePrimaryCtxRetain": [ctypes.POINTER(p), i],
            "cuCtxPushCurrent": [p],
            "cuCtxPopCurrent": [ctypes.POINTER(p)],
            "cuModuleLoadData": [ctypes.POINTER(p), p],
            "cuModuleGetFunction": [ctypes.POINTER(p), p, ctypes.c_char_p],
            "cuFuncSetAttribute": [p, i, i],
            "cuLaunchKernel": [p, u, u, u, u, u, u, u, p,
                               ctypes.POINTER(p), ctypes.POINTER(p)],
            "cuGetErrorName": [i, ctypes.POINTER(ctypes.c_char_p)],
        }
        for name, args in sig.items():
            # the header maps some names to their _v2 symbols
            fn = getattr(lib, name + "_v2", None) or getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
            setattr(lib, "_" + name, fn)
        _LIBS["cuda"] = lib
        return lib


def _check_nvrtc(rc: int, what: str) -> None:
    if rc != 0:
        msg = _nvrtc().nvrtcGetErrorString(rc).decode()
        raise MXNetError(f"NVRTC {what} failed: {msg} ({rc})")


def _check_cu(rc: int, what: str) -> None:
    if rc != 0:
        name = ctypes.c_char_p()
        _cuda()._cuGetErrorName(rc, ctypes.byref(name))
        raise MXNetError(f"CUDA driver {what} failed: "
                         f"{(name.value or b'?').decode()} ({rc})")


def nvrtc_version() -> Tuple[int, int]:
    major, minor = ctypes.c_int(), ctypes.c_int()
    _check_nvrtc(_nvrtc().nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "version")
    return major.value, minor.value


def driver_version() -> int:
    v = ctypes.c_int()
    lib = _cuda()
    _check_cu(lib._cuInit(0), "cuInit")
    _check_cu(lib._cuDriverGetVersion(ctypes.byref(v)), "version")
    return v.value


def _cstrings(items: Sequence[str]):
    arr = (ctypes.c_char_p * max(len(items), 1))()
    for k, s in enumerate(items):
        arr[k] = s.encode()
    return arr


def compile_cubin(source: str, name: str = "rtc.cu",
                  name_expressions: Sequence[str] = (),
                  options: Sequence[str] = ()
                  ) -> Tuple[bytes, Dict[str, str], str]:
    """Compile ``source`` for ``sm_90a``. Returns the CUBIN, the lowered
    (mangled) name of each name expression, and the compiler's log.
    A failed compile raises :class:`MXNetError` with the log."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _check_nvrtc(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                        name.encode(), 0, None, None),
                 "create program")
    try:
        for expr in name_expressions:
            _check_nvrtc(lib.nvrtcAddNameExpression(prog, expr.encode()),
                         f"name expression {expr!r}")
        opts = [f"--gpu-architecture={ARCH}", "-std=c++17"] \
            + [f"-I{d}" for d in include_dirs()] + list(options)
        rc = lib.nvrtcCompileProgram(prog, len(opts), _cstrings(opts))
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace")
        if rc != 0:
            raise MXNetError(f"NVRTC could not compile {name} "
                             f"({lib.nvrtcGetErrorString(rc).decode()}); "
                             f"its log:\n{log}")
        lowered = {}
        for expr in name_expressions:
            out = ctypes.c_char_p()
            _check_nvrtc(lib.nvrtcGetLoweredName(prog, expr.encode(),
                                                 ctypes.byref(out)),
                         f"lowered name of {expr!r}")
            lowered[expr] = out.value.decode()
        _check_nvrtc(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "CUBIN size")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib.nvrtcGetCUBIN(prog, cubin), "CUBIN")
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _primary(device: int) -> ctypes.c_void_p:
    lib = _cuda()
    with _LOCK:
        ctx = _PRIMARY.get(device)
        if ctx is None:
            _check_cu(lib._cuInit(0), "cuInit")
            dev = ctypes.c_int()
            _check_cu(lib._cuDeviceGet(ctypes.byref(dev), device),
                      "cuDeviceGet")
            ctx = ctypes.c_void_p()
            _check_cu(lib._cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                      "cuDevicePrimaryCtxRetain")
            _PRIMARY[device] = ctx
        return ctx


@contextmanager
def _current(device: int):
    """Make ``device``'s primary context current on this thread."""
    lib = _cuda()
    _check_cu(lib._cuCtxPushCurrent(_primary(device)), "cuCtxPushCurrent")
    try:
        yield
    finally:
        popped = ctypes.c_void_p()
        lib._cuCtxPopCurrent(ctypes.byref(popped))


def load_module(cubin: bytes, device: int) -> ctypes.c_void_p:
    """Load a CUBIN into ``device``'s primary context."""
    mod = ctypes.c_void_p()
    image = ctypes.create_string_buffer(cubin, len(cubin))
    with _current(device):
        _check_cu(_cuda()._cuModuleLoadData(ctypes.byref(mod), image),
                  "cuModuleLoadData")
    return mod


def get_function(module: ctypes.c_void_p, name: str, device: int
                 ) -> ctypes.c_void_p:
    fn = ctypes.c_void_p()
    with _current(device):
        _check_cu(_cuda()._cuModuleGetFunction(ctypes.byref(fn), module,
                                               name.encode()),
                  f"cuModuleGetFunction({name})")
    return fn


def set_max_dynamic_shared(fn: ctypes.c_void_p, nbytes: int,
                           device: int) -> None:
    """Allow ``fn`` more than 48 KB of dynamic shared memory."""
    with _current(device):
        _check_cu(_cuda()._cuFuncSetAttribute(fn, _ATTR_MAX_DYNAMIC_SHARED,
                                              int(nbytes)),
                  "cuFuncSetAttribute")


def launch(fn: ctypes.c_void_p, device: int, grid: Sequence[int],
           block: Sequence[int], shared_mem: int, stream: int,
           args: List[ctypes._SimpleCData]) -> None:
    """``cuLaunchKernel`` with ``args`` (ctypes values, each kept alive
    until the call returns) on ``stream`` (a ``cudaStream_t`` as an
    int)."""
    params = (ctypes.c_void_p * max(len(args), 1))(
        *[ctypes.addressof(a) for a in args])
    with _current(device):
        _check_cu(_cuda()._cuLaunchKernel(
            fn, *grid, *block, int(shared_mem), ctypes.c_void_p(stream),
            params, None), "cuLaunchKernel")
