"""The ``.params`` file format: save and load named tensors.

Counterpart of ``mxnet_tpu/ndarray_io.py``, with the same ``MXTPU001``
format, so a file either package writes loads in the other, and the same
dict gives byte-identical files from both. Little-endian:

  magic:   8 bytes  b"MXTPU001"
  count:   uint64
  per tensor:
    name_len uint32, name utf-8
    dtype_len uint32, dtype utf-8 (numpy dtype str, e.g. "<f4", or "bfloat16")
    ndim uint32, shape int64 * ndim
    pad to 64-byte alignment
    data raw bytes (C-order)

bf16 is written and read as its 16-bit patterns (``tensor.view(torch.int16)``
and back), so no ``ml_dtypes`` is needed.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as _np
import torch

from .base import MXNetError
from .context import Context
from .ndarray.ndarray import NDArray

__all__ = ["save_params", "load_params", "save", "load"]

_MAGIC = b"MXTPU001"
_ALIGN = 64


def _payload(value: Any):
    """(dtype string, shape, C-order bytes) of an NDArray, a tensor or an
    array-like."""
    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        t = value.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy()
            return "bfloat16", tuple(t.shape), bits.tobytes(order="C")
        value = t.numpy()
    a = _np.asarray(value)
    if a.dtype.name == "bfloat16":            # an ml_dtypes array
        return "bfloat16", a.shape, a.view(_np.uint16).tobytes(order="C")
    return a.dtype.str, a.shape, a.tobytes(order="C")


def save_params(filename: str, params: Dict[str, Any]) -> None:
    """Save ``{name: NDArray or tensor}`` to ``filename``."""
    with open(filename, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(params)))
        for name, value in params.items():
            dtype_str, shape, data = _payload(value)
            nb, db = name.encode("utf-8"), dtype_str.encode("utf-8")
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<I", len(db)))
            f.write(db)
            f.write(struct.pack("<I", len(shape)))
            for s in shape:
                f.write(struct.pack("<q", s))
            f.write(b"\0" * ((-f.tell()) % _ALIGN))
            f.write(data)


def read_tensors(filename: str) -> Dict[str, torch.Tensor]:
    """``{name: CPU tensor}`` of a ``.params`` file, in the file's dtypes
    (a 64-bit array stays 64-bit here; an NDArray would narrow it)."""
    with open(filename, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise MXNetError(f"{filename} is not a mxnet_tpu .params file "
                             f"(bad magic {magic!r})")
        (count,) = struct.unpack("<Q", f.read(8))
        out: Dict[str, torch.Tensor] = {}
        for _ in range(count):
            (nlen,) = struct.unpack("<I", f.read(4))
            name = f.read(nlen).decode("utf-8")
            (dlen,) = struct.unpack("<I", f.read(4))
            dtype_str = f.read(dlen).decode("utf-8")
            (ndim,) = struct.unpack("<I", f.read(4))
            shape = tuple(struct.unpack("<q", f.read(8))[0]
                          for _ in range(ndim))
            f.read((-f.tell()) % _ALIGN)
            bf16 = dtype_str == "bfloat16"
            dt = _np.dtype("<i2" if bf16 else dtype_str)
            n = int(_np.prod(shape, dtype=_np.int64))
            buf = f.read(n * dt.itemsize)
            if len(buf) != n * dt.itemsize:
                raise MXNetError(f"{filename}: {name!r} is truncated")
            a = _np.frombuffer(buf, dtype=dt).reshape(shape)
            t = torch.from_numpy(a.astype(dt.newbyteorder("="), copy=True))
            out[name] = t.view(torch.bfloat16) if bf16 else t
        return out


def load_params(filename: str, ctx: Optional[Context] = None
                ) -> Dict[str, NDArray]:
    """Load a ``.params`` file into ``{name: NDArray}`` on ``ctx`` (the
    current context by default)."""
    return {k: NDArray(t, ctx=ctx) for k, t in read_tensors(filename).items()}


def save(filename: str,
         data: Union[NDArray, Sequence[NDArray], Dict[str, NDArray]]) -> None:
    """``mx.nd.save``: one array, a list (keys "0", "1", ...) or a dict."""
    if isinstance(data, NDArray):
        data = {"0": data}
    elif isinstance(data, (list, tuple)):
        data = {str(i): a for i, a in enumerate(data)}
    save_params(filename, data)


def load(filename: str, ctx: Optional[Context] = None
         ) -> Union[List[NDArray], Dict[str, NDArray]]:
    """``mx.nd.load``: a list when the keys are 0..n-1, else a dict."""
    d = load_params(filename, ctx=ctx)
    keys = list(d)
    if keys and all(k.isdigit() for k in keys):
        return [d[str(i)] for i in range(len(keys))]
    return d
