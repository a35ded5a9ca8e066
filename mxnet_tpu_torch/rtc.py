"""Runtime-compiled user kernels: ``mx.rtc.CudaModule`` over NVRTC.

The port of ``mxnet_tpu/rtc.py``, whose ``PallasModule.get_kernel`` (``:89``)
compiles a user's kernel body over a grid. On this card the runtime kernel
language is CUDA C++ through NVRTC, which is upstream MXNet's own ``mx.rtc``
API (``src/common/rtc.cc``) that the JAX package cites, so the roles swap:
``CudaModule`` works and ``PallasModule`` raises.

    mod = mx.rtc.CudaModule(source, exports=["axpy"])
    k = mod.get_kernel("axpy", "const float *x, float *y, float alpha")
    k.launch([x, y, 3.0], mx.gpu(0), (n // 256, 1, 1), (256, 1, 1))  # y in place
    f = k.bind(out_shapes=[((n,), "float32")], grid_dims=..., block_dims=...)

``launch`` writes into the arrays it is given, as upstream's does. ``bind``
keeps the JAX package's calling contract: ``f(*ndarrays)`` allocates the
outputs from ``out_shapes``, passes the inputs and then the outputs as the
kernel's pointer arguments (scalars bound by name as keyword arguments of
``bind``), and dispatches through ``invoke``, or through
``invoke_with_custom_vjp`` when a ``vjp`` is given. A kernel without a
``vjp`` cannot be differentiated; with one it joins the tape, and the
``vjp`` may launch further NVRTC kernels.

The CUBIN is compiled for ``sm_90a`` when the module is made (a source that
does not compile raises :class:`MXNetError` with NVRTC's log). Each device
loads it on first launch there and keeps the module and its functions
(``_nvrtc.py`` makes the device's primary context current around each
call, so any thread may launch). A launch goes on torch's current stream
of its device, so it is ordered with torch's own work and needs no
synchronize. Every pointer argument must be a contiguous CUDA tensor on the
launch's device with the signature's dtype; anything else raises. A CPU
NDArray raises: nothing falls back.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from . import _nvrtc
from .base import MXNetError
from .context import as_device
from .ndarray.ndarray import NDArray
from .ndarray.ops import _as_nd
from .ndarray.register import invoke, invoke_with_custom_vjp

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "parse_signature",
           "launches"]

# kernel name -> launches (counted where cuLaunchKernel is called)
launches: Dict[str, int] = {}

# C type -> (torch dtype of a pointer to it, ctypes type of a scalar)
_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "__nv_bfloat16": (torch.bfloat16, ctypes.c_uint16),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
    "int8_t": (torch.int8, ctypes.c_int8),
    "char": (torch.int8, ctypes.c_int8),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
}


class Param:
    """One argument of a kernel signature."""

    __slots__ = ("name", "ctype", "pointer", "const")

    def __init__(self, name: str, ctype: str, pointer: bool, const: bool):
        self.name, self.ctype = name, ctype
        self.pointer, self.const = pointer, const

    @property
    def dtype(self) -> torch.dtype:
        return _TYPES[self.ctype][0]

    def __repr__(self) -> str:
        return (f"{'const ' if self.const else ''}{self.ctype} "
                f"{'*' if self.pointer else ''}{self.name}")


def parse_signature(signature: str) -> List[Param]:
    """Parse an MXNet kernel signature such as
    ``"const float *x, float *y, float alpha, int n"``."""
    params = []
    for part in signature.split(","):
        toks = part.replace("*", " * ").split()
        toks = [t for t in toks if t not in ("__restrict__", "restrict")]
        const = "const" in toks
        stars = toks.count("*")
        rest = [t for t in toks if t not in ("const", "*")]
        if len(rest) != 2 or stars > 1 or rest[0] not in _TYPES:
            raise MXNetError(
                f"rtc: cannot parse argument {part.strip()!r} of signature "
                f"{signature!r}; each argument is a type of "
                f"{sorted(_TYPES)}, optionally const and/or a pointer, and "
                "a name")
        params.append(Param(rest[1], rest[0], stars == 1, const))
    return params


def _scalar_value(p: Param, v: Any) -> ctypes._SimpleCData:
    """A scalar argument in its declared C type (not Python's)."""
    if isinstance(v, (NDArray, torch.Tensor)):
        raise MXNetError(f"rtc: argument {p} is a scalar; got an array")
    ct = _TYPES[p.ctype][1]
    if p.ctype == "__half":
        return ct(int(_np.float16(v).view(_np.uint16)))
    if p.ctype == "__nv_bfloat16":
        bits = torch.tensor(float(v), dtype=torch.bfloat16).view(torch.int16)
        return ct(int(bits.item()) & 0xFFFF)
    return ct(v)


def _pointer_value(p: Param, v: Any, device: torch.device
                   ) -> ctypes.c_void_p:
    t = v._data if isinstance(v, NDArray) else v
    if not isinstance(t, torch.Tensor):
        raise MXNetError(f"rtc: argument {p} is a pointer; got "
                         f"{type(v).__name__}")
    if t.device != device:
        raise MXNetError(f"rtc: argument {p} lies on {t.device}; the "
                         f"kernel launches on {device} (a CUDA tensor on "
                         "that device is required; nothing runs on the CPU)")
    if not t.is_contiguous():
        raise MXNetError(f"rtc: argument {p} is not contiguous")
    if t.dtype != p.dtype:
        raise MXNetError(f"rtc: argument {p} wants {p.dtype}; got {t.dtype}")
    return ctypes.c_void_p(t.data_ptr())


def _dims3(dims: Sequence[int]) -> Tuple[int, int, int]:
    d = tuple(int(x) for x in dims) + (1, 1, 1)
    return d[:3]


class CudaModule:
    """CUDA C++ source compiled by NVRTC for ``sm_90a``.

    ``exports`` names the kernels to resolve through NVRTC name
    expressions (a template instance such as ``"scale<float>"``, or any
    kernel not declared ``extern "C"``); an ``extern "C"`` kernel is also
    found by its plain name. ``options`` go to NVRTC after the port's own
    (``--gpu-architecture=sm_90a -std=c++17`` and ``-I`` for the CUDA
    headers)."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()) -> None:
        self.source = source
        self.exports = tuple(exports)
        self.options = tuple(options)
        self.cubin, self.lowered, self.log = _nvrtc.compile_cubin(
            source, "rtc.cu", self.exports, self.options)
        self._lock = threading.Lock()
        self._modules: Dict[int, ctypes.c_void_p] = {}
        self._functions: Dict[Tuple[int, str], ctypes.c_void_p] = {}
        self._shared: Dict[Tuple[int, str], int] = {}

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` (an export or an ``extern "C"`` name) with
        its argument ``signature``."""
        return CudaKernel(self, name, signature)

    def _function(self, name: str, device: int,
                  shared_mem: int) -> ctypes.c_void_p:
        """The loaded function on ``device``: the module is loaded there
        on first use and kept, per device."""
        key = (device, name)
        with self._lock:
            fn = self._functions.get(key)
            if fn is None:
                mod = self._modules.get(device)
                if mod is None:
                    mod = _nvrtc.load_module(self.cubin, device)
                    self._modules[device] = mod
                fn = _nvrtc.get_function(mod, self.lowered.get(name, name),
                                         device)
                self._functions[key] = fn
            if shared_mem > 48 * 1024 and \
                    self._shared.get(key, 0) < shared_mem:
                _nvrtc.set_max_dynamic_shared(fn, shared_mem, device)
                self._shared[key] = shared_mem
        return fn


class CudaKernel:
    """One kernel of a :class:`CudaModule`."""

    def __init__(self, module: Optional[CudaModule], name: str,
                 signature: str) -> None:
        self.module = module
        self.name = name
        self.params = parse_signature(signature)
        launches.setdefault(name, 0)

    def launch(self, args: Sequence[Any], device: Any,
               grid_dims: Sequence[int], block_dims: Sequence[int],
               shared_mem: int = 0) -> None:
        """Launch on ``device`` with ``args`` in signature order, on
        torch's current stream of that device; pointer arguments
        (NDArrays or tensors) are written in place."""
        if len(args) != len(self.params):
            raise MXNetError(f"rtc: kernel {self.name} takes "
                             f"{len(self.params)} arguments "
                             f"({self.params}); got {len(args)}")
        dev = as_device(device)
        if dev.type != "cuda":
            raise MXNetError(f"rtc: kernel {self.name} launches on a CUDA "
                             f"device; got {dev}")
        values = [_pointer_value(p, a, dev) if p.pointer
                  else _scalar_value(p, a)
                  for p, a in zip(self.params, args)]
        index = dev.index or 0
        fn = self.module._function(self.name, index, shared_mem)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _nvrtc.launch(fn, index, _dims3(grid_dims), _dims3(block_dims),
                      shared_mem, stream, values)
        launches[self.name] += 1

    def bind(self, out_shapes: Sequence[Tuple[Sequence[int], Any]],
             grid_dims: Sequence[int], block_dims: Sequence[int],
             shared_mem: int = 0, vjp: Optional[Callable] = None,
             **scalars: Any) -> Callable:
        """``f(*inputs) -> output(s)`` with this kernel's launch geometry
        and scalars (the JAX package's ``get_kernel`` contract)."""
        def launch(args, device):
            self.launch(args, device, grid_dims, block_dims, shared_mem)
        return bind_launcher(self.name, self.params, out_shapes, launch,
                             vjp, scalars)


def bind_launcher(name: str, params: Sequence[Param],
                  out_shapes: Sequence[Tuple[Sequence[int], Any]],
                  launch: Callable[[List[Any], torch.device], None],
                  vjp: Optional[Callable] = None,
                  scalars: Optional[Dict[str, Any]] = None) -> Callable:
    """The wrapper :meth:`CudaKernel.bind` returns, over any ``launch(args,
    device)`` that runs the kernel on the arguments in signature order
    (outputs written in place). The inputs are the first pointer
    parameters and the outputs the last ``len(out_shapes)``; every scalar
    parameter is bound by name from ``scalars``."""
    scalars = dict(scalars or {})
    pointers = [p for p in params if p.pointer]
    n_in = len(pointers) - len(out_shapes)
    if n_in < 0:
        raise MXNetError(f"rtc: {name} has {len(pointers)} pointer "
                         f"arguments, fewer than {len(out_shapes)} outputs")
    names = {p.name for p in params if not p.pointer}
    if set(scalars) != names:
        raise MXNetError(f"rtc: {name} needs the scalars {sorted(names)} "
                         f"bound by name; got {sorted(scalars)}")
    outs = []
    for (shape, dt), p in zip(out_shapes, pointers[n_in:]):
        dt = dt if isinstance(dt, torch.dtype) else (
            torch.bfloat16 if str(dt) == "bfloat16"
            else getattr(torch, _np.dtype(dt).name))
        if dt != p.dtype:
            raise MXNetError(f"rtc: output {p} of {name} is declared "
                             f"{dt}")
        outs.append((tuple(shape), dt))
    if vjp is not None and len(outs) != 1:
        raise MXNetError("rtc: a vjp needs a kernel with one output")

    def impl(*tensors):
        device = tensors[0].device
        out = [torch.empty(s, dtype=d, device=device) for s, d in outs]
        it, args = iter(list(tensors) + out), []
        for p in params:
            args.append(next(it) if p.pointer else scalars[p.name])
        with torch.no_grad():        # the kernel is opaque to autograd
            launch(args, device)
        return out[0] if len(out) == 1 else tuple(out)

    def f(*inputs):
        if len(inputs) != n_in:
            raise MXNetError(f"rtc: {name} takes {n_in} inputs; got "
                             f"{len(inputs)}")
        nds = tuple(NDArray(x, _wrap=True) if isinstance(x, torch.Tensor)
                    else _as_nd(x) for x in inputs)
        if vjp is None:
            return invoke(f"rtc_{name}", impl, nds)
        arrays = [n._data.detach() for n in nds]
        return invoke_with_custom_vjp(f"rtc_{name}", impl, nds,
                                      lambda cot: vjp(cot, *arrays))

    f.__name__ = name
    return f


class PallasModule:
    """Pallas kernels have no target on this card."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise MXNetError(
            "PallasModule (Pallas kernels) has no GPU target. Write the "
            "kernel in CUDA C++ and compile it with mx.rtc.CudaModule "
            "(NVRTC, sm_90a): CudaModule(source).get_kernel(name, "
            "signature).bind(out_shapes, grid_dims, block_dims) keeps "
            "PallasModule.get_kernel's calling contract.")
