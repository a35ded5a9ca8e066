"""Block / HybridBlock as ``torch.nn.Module`` subclasses.

Counterpart of ``mxnet_tpu/gluon/block.py`` (``Block``, ``HybridBlock``,
``_ParamDict``, ``remat_stack``, ``PreActivation``). A
:class:`~.parameter.Parameter` assigned as an attribute stays the attribute
(``dense.weight``), while its tensor is registered with ``nn.Module`` under
the same name, so ``named_parameters``, ``.to()`` and ``state_dict`` see
it; ``.to()`` and ``cast()`` leave every Parameter bound to the live
tensor. ``collect_params(select)`` returns a :class:`ParameterDict` keyed
by the JAX package's dotted names (``encoder.layers.0.attn_qkv.weight``),
in its order (a block's own parameters, then its children's), with the
batch operations of the JAX package's ``_ParamDict``. ``initialize`` takes
MXNet's arguments; without ``ctx`` it places parameters on the current
context (``cuda:0``). Training behaviour (dropout) follows the
framework flag of ``autograd.record()`` / ``autograd.train_mode()``, as
in the JAX package, not torch's per-module ``training`` attribute.
``HybridBlock.hybridize()`` turns its later calls on CUDA tensors into
CUDA graphs, one per input signature (the JAX package's ``_call_cached``;
:class:`HybridBlock` says how). ``HybridBlock.export`` writes a
``torch.export`` program and its parameters for
``serving.ServedModel.from_export``. ``save_parameters`` /
``load_parameters`` read and write the JAX package's ``.params`` files
(``ndarray_io.py``).
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from .. import autograd as _autograd
from .. import random as _random
from ..base import MXNetError, getenv
from ..random import epoch as _random_epoch
from ..random import renew as _renew_generator
from ..context import as_device
from .parameter import (Parameter, dedupe_shared, resolve_device,
                        to_torch_dtype)

__all__ = ["Block", "HybridBlock", "ParameterDict", "remat_stack",
           "PreActivation"]


class PreActivation:
    """A residual block's output BEFORE its epilogue ReLU, deferred so that
    a consuming 1x1 conv takes the ReLU as its kernel's prologue
    (``ops/cuda/conv_fused.py``). Blocks that understand the deferral set
    ``_consumes_preactivation = True``; every other ``Block.__call__``
    materializes it, so the box never reaches user code."""

    __slots__ = ("z",)

    def __init__(self, z) -> None:
        self.z = z

    def materialize(self):
        return torch.relu(self.z)


def remat_stack(layers, x, *extra, dropout: float = 0.0):
    """Apply ``layers`` in order, passing ``extra`` to each. A plain loop:
    the JAX package's ``MXNET_REMAT`` activation checkpointing is not
    ported yet."""
    for layer in layers:
        x = layer(x, *extra)
    return x


class ParameterDict(OrderedDict):
    """Name → :class:`~.parameter.Parameter` with batch operations (the
    JAX package's ``_ParamDict``, MXNet's ``ParameterDict``)."""

    def initialize(self, init: Any = None, ctx: Any = None,
                   force_reinit: bool = False, verbose: bool = False, *,
                   generator: Optional[torch.Generator] = None,
                   device: Any = None) -> None:
        """Initialize every parameter in order, drawing from one
        ``generator`` (by default the framework generator of the
        device)."""
        dev = resolve_device(ctx, device)
        if generator is None:
            generator = _random.generator(dev)
        for p in self.values():
            p.initialize(init, device=dev, force_reinit=force_reinit,
                         generator=generator)

    def zero_grad(self) -> None:
        for p in self.values():
            p.zero_grad()

    def setattr(self, name: str, value: Any) -> None:
        """Set attribute ``name`` (``grad_req``, ``lr_mult``, ...) of every
        parameter."""
        for p in self.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx: Any) -> None:
        for p in self.values():
            p.reset_ctx(ctx)

    def save(self, filename: str) -> None:
        """Write every initialized persistent parameter to a ``.params``
        file, in its dtype."""
        from ..ndarray_io import save_params
        save_params(filename, {k: p.data().detach() for k, p in self.items()
                               if p.initialized and p.persistent})

    def load(self, filename: str, ctx: Any = None,
             allow_missing: bool = False, ignore_extra: bool = False) -> None:
        """Read a ``.params`` file written by either package. Strict
        unless told otherwise, and checked before anything is set: a
        persistent parameter missing from the file, or a name in the file
        that is not here, raises; so does a shape that differs. Each
        parameter takes the file's value and dtype on its own device (on
        ``ctx`` when given). Non-persistent state is not in a file:
        BatchNorm's ``stat_shift`` is rebuilt as zeros, as
        ``convert.load_jax_params`` does, so the next training forward
        takes centered statistics."""
        from ..ndarray_io import read_tensors
        loaded = read_tensors(filename)
        missing = sorted(k for k, p in self.items()
                         if p.persistent and k not in loaded)
        if missing and not allow_missing:
            raise MXNetError(f"Parameters {missing} missing in file "
                             f"{filename}")
        extra = sorted(set(loaded) - set(self))
        if extra and not ignore_extra:
            raise MXNetError(f"File {filename} contains extra parameters: "
                             f"{extra}")
        bad = [f"{k}: {tuple(loaded[k].shape)} vs {p.shape}"
               for k, p in self.items()
               if k in loaded and tuple(loaded[k].shape) != p.shape]
        if bad:
            raise MXNetError(f"load: shape mismatch: {bad}")
        with torch.no_grad():
            for k, p in self.items():
                if k in loaded:
                    p.set_data(loaded[k])
                elif not p.persistent:
                    p.data().zero_()
                    p.initialized = True
                if ctx is not None:
                    p.reset_ctx(ctx)


class Block(torch.nn.Module):
    """Base class for all layers and models."""

    def __init__(self, prefix: Optional[str] = None, params: Any = None) -> None:
        super().__init__()
        object.__setattr__(self, "_reg_params", OrderedDict())
        self.training = False

    def __setattr__(self, name: str, value: Any) -> None:
        regs = self.__dict__.get("_reg_params")
        if isinstance(value, Parameter):
            super().__setattr__(name, value._var)   # nn.Module's registry
            object.__setattr__(self, name, value)   # the attribute
            regs[name] = value
            return
        if regs is not None and name in regs:
            del regs[name]
            del self.__dict__[name]
        super().__setattr__(name, value)

    def _apply(self, fn, recurse: bool = True):
        """``nn.Module._apply`` (``.to()``, ``.float()``, ...), then each
        Parameter re-bound to its tensor, should torch have replaced it."""
        out = super()._apply(fn, recurse)
        for name, p in self._reg_params.items():
            var = self._parameters.get(name)
            if var is not None and var is not p._var:
                p._bind(var)
        return out

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if args and isinstance(args[0], PreActivation) \
                and not getattr(type(self), "_consumes_preactivation", False):
            args = (args[0].materialize(),) + args[1:]
        return super().__call__(*args, **kwargs)

    def register_child(self, block: "Block", name: Optional[str] = None) -> None:
        self.add_module(name or str(len(self._modules)), block)

    def register_parameter(self, name: str, param: Any) -> Any:
        """MXNet's form: register a :class:`~.parameter.Parameter` under
        ``name`` and return it. Anything else (a ``torch.nn.Parameter`` or
        None) takes ``nn.Module``'s."""
        if isinstance(param, Parameter):
            setattr(self, name, param)
            return param
        return super().register_parameter(name, param)

    @property
    def params(self) -> ParameterDict:
        """This block's own parameters (not its children's)."""
        return ParameterDict(self._reg_params)

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """All parameters of self and descendants, keyed by attribute path;
        ``select`` keeps the names a regular expression matches (at their
        start, as ``re.match``)."""
        out = ParameterDict()
        self._collect_params(out, "")
        if select is not None:
            pat = re.compile(select)
            out = ParameterDict((k, p) for k, p in out.items()
                                if pat.match(k))
        return out

    def _collect_params(self, out: ParameterDict, prefix: str) -> None:
        for name, p in self._reg_params.items():
            out[prefix + name] = p
        for cname, child in self._modules.items():
            if isinstance(child, Block):
                child._collect_params(out, f"{prefix}{cname}.")

    def initialize(self, init: Any = None, ctx: Any = None,
                   verbose: bool = False, force_reinit: bool = False, *,
                   generator: Optional[torch.Generator] = None,
                   device: Any = None) -> "Block":
        """Fill every parameter not yet initialized (all of them with
        ``force_reinit``) from ``init`` (else its own initializer, else
        ``Uniform()``, the JAX package's precedence), drawing from
        ``generator`` (by default the framework generator of the device,
        :func:`mxnet_tpu_torch.random.generator`), and move the block to
        ``ctx`` / ``device``: the same argument under MXNet's name and the
        port's; neither means the current context (``cuda:0``)."""
        dev = resolve_device(ctx, device)
        self.collect_params().initialize(init, dev, force_reinit, verbose,
                                         generator=generator)
        return self.to(dev)

    def cast(self, dtype: Any) -> "Block":
        return self.to(to_torch_dtype(dtype))

    def reset_ctx(self, ctx: Any) -> None:
        """Move every parameter to ``ctx``."""
        self.collect_params().reset_ctx(ctx)

    def summary(self, *inputs: Any) -> str:
        """Print and return a table of every parameter's name, shape and
        size, and their total (the JAX package's ``nn_block_summary``)."""
        lines = [f"{'Layer':<40}{'Output Shape':<24}{'Param #':<12}"]
        total = 0
        for name, p in self.collect_params().items():
            n = 1
            for d in p.shape:
                n *= d
            total += n
            lines.append(f"{name:<40}{str(p.shape):<24}{n:<12}")
        lines.append(f"Total params: {total}")
        out = "\n".join(lines)
        print(out)
        return out

    def hybridize(self, active: bool = True, **kwargs: Any) -> None:
        """Hybridize (or not) every HybridBlock below: a plain Block runs
        eagerly itself (MXNet's ``Block.hybridize``)."""
        for child in self._modules.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def save_parameters(self, filename: str, deduplicate: bool = False
                        ) -> None:
        """Save every initialized persistent parameter, by its
        ``collect_params()`` name, in the parameter's dtype."""
        self.collect_params().save(filename)

    def load_parameters(self, filename: str, ctx: Any = None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False,
                        cast_dtype: bool = False) -> "Block":
        """Load a ``.params`` file written by either package
        (:meth:`ParameterDict.load`)."""
        self.collect_params().load(filename, allow_missing=allow_missing,
                                   ignore_extra=ignore_extra)
        return self if ctx is None else self.to(as_device(ctx))


# The settings read while a forward runs that change what it launches: part
# of a graph's key, as the JAX package keys on ``_remat_enabled()``.
_PROGRAM_ENV = ("MXNET_FUSE_BN_CONV", "MXNET_FLASH_BLOCK_K", "MXNET_BN_STATS")
# One capture or replay at a time in the process; a capture (or an export
# trace) under way on this thread runs hybridized blocks inline.
_GRAPH_LOCK = threading.RLock()
_CAPTURE = threading.local()


def _capturing() -> bool:
    return getattr(_CAPTURE, "active", False)


def _np_dtype(dtype):
    """numpy's dtype of a torch dtype (the torch dtype where numpy has
    none, as for bfloat16)."""
    try:
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError:
        return dtype


def _flatten(out, leaves):
    """The tensors of a (nested) tuple / list output appended to
    ``leaves``; returns the structure with each tensor's position."""
    if isinstance(out, PreActivation):
        out = out.materialize()
    if isinstance(out, torch.Tensor):
        leaves.append(out)
        return len(leaves) - 1
    if isinstance(out, (tuple, list)):
        return type(out), [_flatten(o, leaves) for o in out]
    if out is None or isinstance(out, (bool, int, float, str)):
        return ("const", out)
    raise MXNetError(f"hybridize: a graphed call returned a "
                     f"{type(out).__name__}; outputs are tensors, tuples or "
                     "lists of them, and constants")


def _unflatten(spec, leaves):
    if isinstance(spec, int):
        return leaves[spec]
    if spec[0] == "const":
        return spec[1]
    kind, items = spec
    return kind(_unflatten(sp, leaves) for sp in items)


class _Graph:
    """One signature's captured call: the forward graph and, for a call
    under ``autograd.record()``, the backward graph, with their static
    buffers."""

    def __init__(self) -> None:
        self.fwd = self.bwd = None
        self.static_in = []        # the tensor arguments' buffers
        self.static_out = []       # the forward's output tensors
        self.spec = None           # the output's structure
        self.diff = []             # per output: does it take a gradient
        self.gout = []             # the backward's output-gradient buffers
        self.grads = []            # per static input, then per parameter
        self.params = []           # the parameters the backward reaches
        self.gated = []            # layers with a _graph_ready check
        self.generation = 0        # forward replays so far

    def forward(self, tensors):
        """Copy the arguments in, replay, return fresh output tensors."""
        with _GRAPH_LOCK, torch.no_grad():
            for buf, t in zip(self.static_in, tensors):
                buf.copy_(t)
            self.fwd.replay()
            self.generation += 1
            return [o.clone() for o in self.static_out]

    def backward(self, gouts):
        with _GRAPH_LOCK, torch.no_grad():
            for buf, g in zip(self.gout, gouts):
                if g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)
            self.bwd.replay()
            return [None if g is None else g.clone() for g in self.grads]


class _GraphedCall(torch.autograd.Function):
    """A graphed call under ``autograd.record()``: the forward graph's
    replay, with the backward graph's replay as its backward. Inputs: the
    tensor arguments, then the parameters (which the graphs read in
    place); the gradients come back as fresh tensors, so a parameter's
    ``grad`` is never a graph's buffer and ``grad_req='add'``
    accumulates."""

    @staticmethod
    def forward(ctx, graph, n_in, *tensors):
        outs = graph.forward(tensors[:n_in])
        ctx.graph, ctx.generation = graph, graph.generation
        ctx.mark_non_differentiable(
            *[o for o, d in zip(outs, graph.diff) if not d])
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *gouts):
        graph = ctx.graph
        if ctx.generation != graph.generation:
            raise MXNetError(
                "hybridize: the backward of a graphed call ran after a later "
                "call of the same signature replayed the graph over the "
                "activations it saved; run backward before calling the "
                "block again under autograd.record(), or hybridize(False)")
        grads = graph.backward([g for g, d in zip(gouts, graph.diff) if d])
        return (None, None) + tuple(grads)


class HybridBlock(Block):
    """A Block that ``hybridize()`` runs as CUDA graphs: the counterpart of
    the JAX package's compiled ``HybridBlock`` (``_call_cached``).

    A hybridized block's calls on CUDA tensors go through one CUDA graph
    per signature: the tensor arguments' shapes, dtypes and device (other
    arguments by value), training or predict mode, whether autograd
    records, grad and inference mode, and the settings that change what a
    forward launches (``MXNET_FUSE_BN_CONV``, ``MXNET_FLASH_BLOCK_K``,
    ``MXNET_BN_STATS``). The first call of a signature runs eagerly and is
    the warm-up (kernel libraries load, BatchNorm's first, centered step
    reads the device); the second captures the block's forward and, under
    ``autograd.record()``, its backward (as ``torch.autograd.grad`` of the
    outputs over the tensor arguments and the parameters that take
    gradients, the way ``torch.cuda.make_graphed_callables`` builds it),
    then replays; later calls replay. A capture runs nothing on the
    device, so the warm-up, the capture and each replay leave the running
    statistics and the random streams as one eager call each would: the
    framework generator of the device is registered with every graph, and
    a replay advances it as the eager call would, so a replay draws the
    same dropout bits as an eager call from the same generator state, and
    the next replay draws new ones.

    Arguments are copied into the graph's static buffers; outputs and
    gradients come back as fresh tensors (the JAX package returns new
    arrays). The graphs read the parameters in place, so the trainer's
    in-place update reaches them; a parameter replaced by another tensor
    (``cast``, ``reset_ctx``, ``set_data``), a ``grad_req`` changed to or
    from ``'null'``, ``random.seed``, and ``hybridize()`` itself drop the
    block's graphs. A BatchNorm whose
    first, centered step is ahead (after a load) sends the call eager
    again. Graphs without a backward share one memory pool a block (the
    serving buckets); a recorded signature's forward and backward graphs
    have a pool of their own, which holds the activations between the two
    replays. A recorded call's backward must run before the next call of
    its signature: a later one raises ``MXNetError``.

    Captures and replays take one lock, and capture in thread-local mode,
    so a replica thread launching work meanwhile does not break a capture.
    A hybridized child called inside its parent's capture runs inline:
    captures do not nest. CPU tensors run the block eagerly, the port's
    plain path on the CPU. On CUDA tensors a capture that fails raises
    ``MXNetError`` with its cause; nothing runs eager in its place. It
    renews the framework generator of the device first
    (:func:`~mxnet_tpu_torch.random.renew`): PyTorch ends a failed capture
    without releasing the generators registered with it."""

    def __init__(self, prefix: Optional[str] = None, params: Any = None) -> None:
        super().__init__(prefix, params)
        self._active = False
        self._flags: dict = {}
        self._cached_graph: dict = {}
        self._graph_pool = None
        self._cache_for = None
        self._last_sig = None

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, **kwargs: Any) -> None:
        """Run later calls on CUDA tensors as CUDA graphs (``active``) or
        eagerly; either way the cached graphs are dropped, and the
        children's too (they run inside this block's graphs)."""
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._drop_graphs()
        for child in self.modules():
            if isinstance(child, HybridBlock) and child is not self:
                child._drop_graphs()

    def _drop_graphs(self) -> None:
        with _GRAPH_LOCK:
            self._cached_graph.clear()
            self._graph_pool = None
            self._cache_for = None

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if not self._active or _capturing():
            return super().__call__(*args, **kwargs)
        args = tuple(a.materialize() if isinstance(a, PreActivation) else a
                     for a in args)
        names = tuple(kwargs)
        flat = args + tuple(kwargs.values())
        tensors = [a for a in flat if isinstance(a, torch.Tensor)]
        self._last_sig = [(tuple(t.shape), _np_dtype(t.dtype))
                          for t in tensors]
        if not any(t.is_cuda for t in tensors):
            return super().__call__(*args, **kwargs)
        return self._call_cached(flat, names, tensors)

    def _graph_key(self, flat, names) -> tuple:
        sig = tuple((tuple(a.shape), a.dtype, a.device, a.requires_grad)
                    if isinstance(a, torch.Tensor) else ("value", a)
                    for a in flat)
        recording = _autograd.is_recording() and torch.is_grad_enabled()
        return (sig, names, _autograd.is_training(), recording,
                torch.is_inference_mode_enabled(),
                tuple(str(getenv(k, "")) for k in _PROGRAM_ENV))

    def _fingerprint(self) -> tuple:
        """What the graphs were captured against: the random streams'
        epoch, and every parameter's address and whether it takes a
        gradient (a backward graph computes the gradients of the
        parameters that took one at capture)."""
        return (_random_epoch(),) + tuple((t.data_ptr(), t.requires_grad)
                                          for t in self.parameters())

    def _check_cache(self) -> None:
        """Drop the graphs if the random streams were reseeded, or a
        parameter was replaced or frozen or unfrozen, since they were
        captured."""
        fp = self._fingerprint()
        if self._cache_for != fp:
            self._drop_graphs()
            self._cache_for = fp

    def _call_cached(self, flat, names, tensors):
        devs = {t.device for t in tensors}
        if len(devs) != 1:
            raise MXNetError(f"hybridize: the tensor arguments lie on "
                             f"{sorted(map(str, devs))}; a graphed call "
                             "takes them on one CUDA device")
        key = self._graph_key(flat, names)
        try:
            hash(key)
        except TypeError as e:
            raise MXNetError("hybridize: a graphed call takes tensors and "
                             f"hashable constants as arguments ({e})") from e
        with _GRAPH_LOCK:
            self._check_cache()
            graph = self._cached_graph.get(key)
            gated = graph.gated if isinstance(graph, _Graph) else [
                m for m in self.modules() if hasattr(m, "_graph_ready")]
            # the signature's first call, or a layer whose next call must
            # read the device (BatchNorm's centered step): eager, and the
            # warm-up of the capture
            ready = graph is not None and all(m._graph_ready()
                                              for m in gated)
            if ready and graph is True:
                graph = self._capture(key, flat, names, tensors)
                graph.gated = gated
                self._cached_graph[key] = graph
        if not ready:
            n = len(flat) - len(names)
            out = super().__call__(*flat[:n], **dict(zip(names, flat[n:])))
            with _GRAPH_LOCK:
                self._cached_graph.setdefault(key, True)
            return out
        if graph.bwd is None:
            outs = graph.forward(tensors)
        else:
            outs = _GraphedCall.apply(graph, len(tensors), *tensors,
                                      *graph.params)
        return _unflatten(graph.spec, list(outs))

    def _capture(self, key, flat, names, tensors) -> "_Graph":
        """Capture this signature's forward (and, recording, backward);
        the caller holds the graph lock."""
        recording = key[3]
        dev = tensors[0].device
        g = _Graph()
        with torch.no_grad():
            g.static_in = [torch.empty_like(t).copy_(t) for t in tensors]
        for buf, t in zip(g.static_in, tensors):
            buf.requires_grad_(recording and t.requires_grad)
        it = iter(g.static_in)
        call = [next(it) if isinstance(a, torch.Tensor) else a
                for a in flat]
        n = len(call) - len(names)
        gen = _random.generator(dev)
        if recording:
            pool = None
        else:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            pool = self._graph_pool
        # the parameters that take gradients, each read through a fresh
        # leaf on its storage while capturing: the backward graph then
        # never meets the parameters' own AccumulateGrad nodes, which a
        # live loss of an eager step keeps on the default stream
        owners = self._grad_owners() if recording else []
        aliases = [p._var.detach().requires_grad_() for p in owners]
        g.params = [p._var for p in owners]
        _CAPTURE.active = True
        stage = "forward"
        try:
            for p, a in zip(owners, aliases):
                p._var = a
            with torch.cuda.device(dev):
                g.fwd = self._new_graph(gen)
                grad_mode = torch.enable_grad() if recording \
                    else torch.no_grad()
                with torch.cuda.graph(g.fwd, pool=pool,
                                      capture_error_mode="thread_local"):
                    with grad_mode:
                        out = Block.__call__(self, *call[:n], **dict(
                            zip(names, call[n:])))
                g.spec = _flatten(out, g.static_out)
                g.diff = [recording and o.requires_grad
                          for o in g.static_out]
                if any(g.diff):
                    stage = "backward"
                    self._capture_backward(g, gen, aliases)
        except Exception as e:
            # the failed capture left the generator it registered in
            # capture mode: later draws would raise
            _renew_generator(dev)
            raise MXNetError(
                f"hybridize: capturing {type(self).__name__}'s {stage} "
                f"for {[(tuple(t.shape), str(t.dtype)) for t in tensors]}"
                f" failed: {type(e).__name__}: {e}") from e
        finally:
            _CAPTURE.active = False
            for p, var in zip(owners, g.params):
                p._var = var
        g.static_out = [o.detach() for o in g.static_out]
        return g

    @staticmethod
    def _new_graph(gen):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        return graph

    def _grad_owners(self) -> list:
        """The block's Parameters that take gradients, each once."""
        owners, seen = [], set()
        for p in self.collect_params().values():
            if p._var.requires_grad and id(p) not in seen:
                seen.add(id(p))
                owners.append(p)
        loose = {id(t) for t in self.parameters() if t.requires_grad} - {
            id(p._var) for p in owners}
        if loose:
            raise MXNetError("hybridize: a graphed backward takes the "
                             "gradients of gluon Parameters; this block "
                             f"holds {len(loose)} other torch parameters")
        return owners

    def _capture_backward(self, g, gen, leaves) -> None:
        outs = [o for o, d in zip(g.static_out, g.diff) if d]
        g.gout = [torch.empty_like(o) for o in outs]
        ins = [t for t in g.static_in if t.requires_grad]
        g.bwd = self._new_graph(gen)
        with torch.cuda.graph(g.bwd, pool=g.fwd.pool(),
                              capture_error_mode="thread_local"):
            grads = torch.autograd.grad(outs, ins + leaves,
                                        grad_outputs=g.gout,
                                        allow_unused=True)
        grads = iter(grads)
        g.grads = [next(grads) if t.requires_grad else None
                   for t in g.static_in] + [next(grads) for _ in leaves]

    # -- export / deploy -----------------------------------------------------
    def export(self, path: str, epoch: int = 0,
               input_signature: Optional[Sequence[tuple]] = None,
               dynamic_batch: bool = False) -> Tuple[str, str]:
        """Write ``path-symbol.json`` and ``path-NNNN.params`` for
        :meth:`ServedModel.from_export`; returns their paths. The JAX
        package's ``HybridBlock.export`` (``block.py:521-592``) with a
        ``torch.export`` program in place of StableHLO: the two packages
        cannot load each other's exports.

        The program is the block's plain forward, traced in predict mode
        with gradients off, never through its CUDA graphs, on the device
        its parameters lie on. Its arguments are the parameters, then the
        inputs: the parameters are not constants in it, so the program is
        the same for any weights (``torch.func.functional_call`` swaps
        ``nn.Module``'s registry, which the layers do not read; the trace
        rebinds each Parameter's tensor, as a graph capture does). A tied
        parameter is traced once, under its first name; the ``.params``
        file (``ndarray_io.save_params``) carries every name.

        ``input_signature``: per input (shape with the batch axis, dtype);
        by default the last hybridized call's. ``dynamic_batch=True``
        makes the batch axis of every input one ``torch.export.Dim``, so
        one program serves every batch bucket; the trace then takes a
        batch of at least 2 (sizes 0 and 1 would be specialised). A
        forward that writes a parameter (training-mode statistics) raises.
        The symbol json holds ``framework``, ``format_version``, the
        inputs, ``dynamic_batch``, ``param_order``, the program (base64 of
        ``torch.export.save``) and the digests ``program_sha256`` and
        ``params_sha256``."""
        import base64
        import io
        import json

        import numpy as np
        from .._durable import sha256_bytes, sha256_file
        from ..ndarray_io import save_params
        from ..serving.model import EXPORT_FRAMEWORK

        if input_signature is None:
            input_signature = self._last_sig
        if input_signature is None:
            raise MXNetError(
                "export() needs the input signature: run the block once "
                "(after hybridize()) or pass input_signature=[(shape, "
                "dtype), ...]")
        named = [(k, p) for k, p in self.collect_params().items()
                 if p.is_initialized]
        names, plist = dedupe_shared(named)
        dev = plist[0].data().device if plist else torch.device("cpu")
        sig = [(tuple(int(d) for d in s), dt) for s, dt in input_signature]
        batch = max(2, sig[0][0][0]) if dynamic_batch else sig[0][0][0]
        xs = tuple(torch.zeros((batch,) + s[1:], dtype=to_torch_dtype(dt),
                               device=dev) for s, dt in sig)
        params = [p.data().detach() for p in plist]
        dims = None
        if dynamic_batch:
            b = torch.export.Dim("batch")
            # (params, the varargs' tuple of inputs)
            dims = ([None] * len(params), tuple({0: b} for _ in xs))
        program = _ExportProgram(self, plist)
        try:
            _CAPTURE.active = True
            with torch.no_grad(), _autograd.predict_mode():
                ep = torch.export.export(program, (params,) + xs,
                                         dynamic_shapes=dims, strict=False)
        finally:
            _CAPTURE.active = False
        # the saved program keeps torch's training IR (views and in-place
        # ops as eager runs them); its functional form names the inputs an
        # in-place op writes
        if ep.run_decompositions({}).graph_signature.user_inputs_to_mutate:
            raise MXNetError(
                "export traced a forward that mutates parameter state "
                "(training-mode BatchNorm?); export runs in inference "
                "mode — check autograd/use_global_stats configuration")
        # the example inputs are the weights: the program is saved without
        ep.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        blob = buf.getvalue()
        meta = {
            "framework": EXPORT_FRAMEWORK,
            "format_version": 1,
            "block": type(self).__name__,
            "dynamic_batch": bool(dynamic_batch),
            "inputs": [{"shape": list(s), "dtype": str(np.dtype(
                _np_dtype(dt) if isinstance(dt, torch.dtype) else dt))}
                for s, dt in sig],
            "params": {k: {"shape": list(p.shape), "dtype": str(p.dtype)}
                       for k, p in zip(names, plist)},
            "param_order": names,
            "program": base64.b64encode(blob).decode("ascii"),
            "program_sha256": sha256_bytes(blob),
        }
        # the file carries every name, aliases included, as the JAX
        # package's does; only the trace deduplicated
        param_file = f"{path}-{epoch:04d}.params"
        save_params(param_file, {k: p.data().detach() for k, p in named})
        meta["params_sha256"] = sha256_file(param_file)
        sym_file = f"{path}-symbol.json"
        with open(sym_file, "w") as f:
            json.dump(meta, f, indent=2)
        return sym_file, param_file


class _ExportProgram(torch.nn.Module):
    """What ``HybridBlock.export`` traces: ``forward(params, *inputs)``
    runs the block with each Parameter's tensor rebound to the argument
    in its place. The block is held outside ``nn.Module``'s registry, so
    its tensors do not become the program's state."""

    def __init__(self, block: "HybridBlock", params) -> None:
        super().__init__()
        object.__setattr__(self, "_block", block)
        object.__setattr__(self, "_params", list(params))

    def forward(self, params, *xs):
        saved = [p._var for p in self._params]
        try:
            for p, t in zip(self._params, params):
                p._var = t
            out = Block.__call__(self._block, *xs)
        finally:
            for p, var in zip(self._params, saved):
                p._var = var
        if isinstance(out, PreActivation):
            out = out.materialize()
        return out
