"""Content digests of the export artifacts.

An own copy of ``mxnet_tpu/_durable.py``'s ``sha256_file`` and
``sha256_bytes`` (``:64-73``): ``HybridBlock.export`` writes them and
``ServedModel.from_export`` checks them before it deserialises anything.
"""
from __future__ import annotations

import hashlib

__all__ = ["sha256_file", "sha256_bytes"]


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()
