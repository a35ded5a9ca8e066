"""Inference serving: bucket policy, dynamic batcher, served model, server,
the generation engine (KV cache, decode model, speculation, generation
server) and the HTTP front end (the JAX package's ``serving/__init__.py``)."""
from .batching import (BucketPolicy, DynamicBatcher, OverloadError,  # noqa: F401
                       Request, SlotScheduler)
from .model import DecodeModel, ServedModel, load_served  # noqa: F401
from .kv_cache import PagedKVCache, PrefixCache  # noqa: F401
from .generation import (GenerationEngine, GenRequest, StreamTimeout,  # noqa: F401
                         TokenStream, make_recovery_request)
from .speculation import (DraftModel, IndependentDraft,  # noqa: F401
                          SelfSpeculativeDraft, make_draft)
from .replica import ReplicaSupervisor  # noqa: F401
from .server import DegradedError, GenerationServer, ModelServer  # noqa: F401
from .http import make_http_server  # noqa: F401

__all__ = ["BucketPolicy", "DynamicBatcher", "OverloadError", "Request",
           "SlotScheduler", "ServedModel", "load_served", "DecodeModel",
           "PagedKVCache", "PrefixCache", "GenerationEngine", "GenRequest",
           "StreamTimeout", "TokenStream", "make_recovery_request", "DraftModel",
           "IndependentDraft", "SelfSpeculativeDraft", "make_draft",
           "ModelServer", "GenerationServer", "DegradedError",
           "ReplicaSupervisor", "make_http_server"]
