"""Inference serving: bucket policy, dynamic batcher, served model, server,
and the HTTP front end (the JAX package's ``serving/__init__.py``, without
the generation engine of ROADMAP Queue A 5)."""
from .batching import BucketPolicy, DynamicBatcher, OverloadError, Request  # noqa: F401
from .model import ServedModel  # noqa: F401
from .replica import ReplicaSupervisor  # noqa: F401
from .server import DegradedError, ModelServer  # noqa: F401
from .http import make_http_server  # noqa: F401

__all__ = ["BucketPolicy", "DynamicBatcher", "OverloadError", "Request",
           "ServedModel", "ModelServer", "DegradedError",
           "ReplicaSupervisor", "make_http_server"]
