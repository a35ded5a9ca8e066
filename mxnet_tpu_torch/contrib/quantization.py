"""INT8 post-training quantization: ``quantize_net``.

Counterpart of ``mxnet_tpu/contrib/quantization.py`` (upstream MXNet's
``python/mxnet/contrib/quantization.py``): ``quantize_net`` with naive
(min / max), entropy (KL-optimal threshold) or no calibration, excluded
layers, and the int8 replacements ``QuantizedDense`` and ``QuantizedConv``
swapped into the net's children in place. Calibration observes each target
layer's input on eager forwards (forward pre-hooks; a hybridized net is
run eagerly for it and hybridized again after), and the observers'
histograms and the KL sweep are the JAX package's numpy code (the sweep's
inner loop vectorized, to the same values).

A quantized layer keeps its int8 weight and bias, their ranges and its
calibrated input range as buffers on the layer's device, and its weight
packed once for the kernel (a buffer that ``state_dict`` and
``save_parameters`` leave out). A forward is one launch of the int8
kernel's f32 variant (``ops/cuda/int8_conv.py``: ``conv_f32`` /
``fully_connected_f32``), which quantizes the f32 input as it stages it,
runs the int8 product and dequantizes (and relu's) in its epilogue: the
bits of ``quantize_v2`` -> ``quantized_conv`` /
``quantized_fully_connected`` -> ``dequantize`` -> activation. Its
constants (the input's scale, the output's step, the bias rescaled into
the accumulator's step: ``ops/quantization.int8_layer_constants``) are
computed once with a calibrated range, per batch without one. A forward
reads nothing back to the host and runs as one CUDA graph under
``hybridize()``. A quantized convolution takes a materialized input: it is
not a ``Conv2D``, so the BatchNorm -> relu -> 1x1-conv fusion never
matches it.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from ..base import MXNetError
from ..gluon.block import HybridBlock
from ..gluon.nn.basic_layers import Dense
from ..gluon.nn.conv_layers import _Conv
from ..ops import nn as npx
from ..ops import quantization as qop
from ..ops.cuda import int8_conv as i8

__all__ = ["quantize_net", "QuantizedDense", "QuantizedConv",
           "optimal_threshold_entropy"]


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

_NBINS = 2048
_QLEVELS = 255


def optimal_threshold_entropy(hist: onp.ndarray, edges: onp.ndarray
                              ) -> float:
    """KL-optimal |threshold| from an abs-value histogram: for each
    candidate clip point, P is the clipped distribution and Q P re-binned
    to 255 int8 levels; the argmin of KL(P || Q)."""
    total = hist.sum()
    if total == 0:
        return float(edges[-1])
    best_kl, best_t = onp.inf, float(edges[-1])
    for i in range(_QLEVELS, len(hist) + 1, 8):
        p = hist[:i].astype(onp.float64).copy()
        p[i - 1] += hist[i:].sum()          # clip mass onto the edge bin
        num_merged = i // _QLEVELS
        if num_merged == 0:
            continue
        # the JAX package's loop over the 255 merged chunks (the last runs
        # to i), each spreading its sum over its nonzero bins; vectorized,
        # the same values: the counts are whole numbers, so every sum is
        # exact in any order
        starts = onp.arange(_QLEVELS) * num_merged
        h = hist[:i]
        sums = onp.add.reduceat(h, starts)
        nz = onp.add.reduceat((h > 0).astype(onp.int64), starts)
        lengths = onp.diff(onp.append(starts, i))
        spread = onp.repeat(sums / onp.maximum(nz, 1), lengths)
        q = onp.where(h > 0, spread, 0.0).astype(onp.float64)
        p /= p.sum()
        qs = q.sum()
        if qs == 0:
            continue
        q /= qs
        mask = p > 0
        kl = float((p[mask] * onp.log(
            p[mask] / onp.maximum(q[mask], 1e-12))).sum())
        if kl < best_kl:
            best_kl, best_t = kl, float(edges[i])
    return best_t


class _Observer:
    """Records a layer's input range during calibration forwards."""

    def __init__(self, mode: str) -> None:
        self.mode = mode
        self.mn = onp.inf
        self.mx = -onp.inf
        self.hist = onp.zeros(_NBINS)
        self.absmax = 0.0

    def update(self, x: torch.Tensor) -> None:
        """``x``: the layer's input; its min and max are taken where it
        lies, and only an entropy observer copies it to the host."""
        self.mn = min(self.mn, float(x.min()))
        self.mx = max(self.mx, float(x.max()))
        if self.mode == "entropy":
            a = onp.abs(x.float().cpu().numpy()).ravel()
            amax = float(a.max()) if a.size else 0.0
            if amax > self.absmax and self.absmax > 0:
                # rescale old histogram onto the wider range
                old_edges = onp.linspace(0, self.absmax, _NBINS + 1)
                centers = (old_edges[:-1] + old_edges[1:]) / 2
                new_hist, _ = onp.histogram(
                    centers, bins=_NBINS, range=(0, amax),
                    weights=self.hist)
                self.hist = new_hist
                self.absmax = amax
            self.absmax = max(self.absmax, amax)
            h, _ = onp.histogram(a, bins=_NBINS, range=(0, self.absmax or 1))
            self.hist += h

    def range(self) -> Tuple[float, float]:
        if self.mode == "entropy":
            edges = onp.linspace(0, self.absmax or 1.0, _NBINS + 1)
            t = optimal_threshold_entropy(self.hist, edges)
            return -t, t
        return self.mn, self.mx


# ---------------------------------------------------------------------------
# Quantized layers
# ---------------------------------------------------------------------------

def _stamp(t: Optional[torch.Tensor]):
    """Where ``t`` lies and how often it was written in place (None for
    None): a changed stamp says a cached value computed from it is stale.
    An inference tensor counts no writes, so nothing computed from it may
    be cached: its stamp is a new object, equal to no other."""
    if t is None:
        return None
    if t.is_inference():
        return object()
    return t.data_ptr(), t._version


class _QuantizedLayer(HybridBlock):
    """The state both int8 layers share: the int8 weight and bias with
    their ranges, and the input range (None: each batch's own), all
    buffers on the float layer's device; the weight packed once for the
    kernel (a buffer that is not saved); and, with a calibrated range, the
    layer's constants (scale, step, rescaled bias), computed once and again
    only when a range or the bias is written. The buffers are made outside
    inference mode, so they count their writes even when the layer is
    built, or loaded, inside it; a buffer replaced by an inference tensor
    is never cached from (:func:`_stamp`)."""

    def __init__(self, layer, in_range) -> None:
        super().__init__()
        self._activation = layer._activation
        self._in_min, self._in_max = in_range
        with torch.inference_mode(False), torch.no_grad():
            w = layer.weight.data().detach()
            for name, t in (("w", w), ("b", None if layer.bias is None
                                        else layer.bias.data().detach())):
                q, mn, mx = (None, None, None) if t is None else \
                    qop.quantize_v2(t, out_type="int8")
                self.register_buffer(name + "q", q)
                self.register_buffer(name + "min", mn)
                self.register_buffer(name + "max", mx)
            if self._in_min is not None:
                self.register_buffer("in_min", torch.tensor(
                    self._in_min, dtype=torch.float32, device=w.device))
                self.register_buffer("in_max", torch.tensor(
                    self._in_max, dtype=torch.float32, device=w.device))
            self._repack()
        self._consts = None

    def _pack(self) -> i8.Packed:
        raise NotImplementedError

    def _repack(self) -> None:
        p = self._pack()
        self.register_buffer("wpack", p.w, persistent=False)
        self._Kp, self._cf, self._w_stamp = p.Kp, p.cf, _stamp(self.wq)

    def _packed(self) -> i8.Packed:
        """The packed weight, packed again (and counted) if ``wq`` was
        written since."""
        if _stamp(self.wq) != self._w_stamp:
            self._repack()
            with i8._COUNT_LOCK:
                i8.copies["weight"] += 1
        return i8.Packed(self.wpack, self._Kp, self._cf)

    def _constants(self, x):
        """(scale, step, bias32) of a forward on ``x``: from ``x``'s own
        range without a calibrated one, else the cached ones."""
        ranges = (self.wmin, self.wmax, self.bq, self.bmin, self.bmax)
        if self._in_min is None:
            return qop.int8_layer_constants(x.min().float(),
                                            x.max().float(), *ranges)
        key = tuple(_stamp(t) for t in (self.in_min, self.in_max) + ranges)
        if self._consts is None or self._consts[0] != key:
            self._consts = (key, qop.int8_layer_constants(
                self.in_min, self.in_max, *ranges))
        return self._consts[1]

    def _activate(self, out, fused: bool):
        if self._activation and not fused:
            out = npx.activation(out, self._activation)
        return out


class QuantizedDense(_QuantizedLayer):
    """int8 replacement for ``gluon.nn.Dense`` (inference only)."""

    def __init__(self, layer: Dense, in_range: Tuple[float, float],
                 **kwargs: Any) -> None:
        self._units = layer._units
        self._flatten = layer._flatten
        super().__init__(layer, in_range)

    def _pack(self) -> i8.Packed:
        N, K = self.wq.shape
        return i8.pack_weight(self.wq.reshape(N, K, 1), "NCW", False)[0]

    def forward(self, x):
        x = x.float()
        scale, step, b32 = self._constants(x)
        if self._flatten and x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        relu = self._activation == "relu"
        y = i8.fully_connected_f32(x.reshape(-1, x.shape[-1]), self.wq, b32,
                                   scale, step, relu, packed=self._packed())
        return self._activate(y.reshape(x.shape[:-1] + (y.shape[-1],)), relu)

    def __repr__(self) -> str:
        return f"QuantizedDense(-> {self._units}, int8)"


class QuantizedConv(_QuantizedLayer):
    """int8 replacement for ``gluon.nn.Conv*D`` (inference only)."""

    def __init__(self, layer: _Conv, in_range: Tuple[float, float],
                 **kwargs: Any) -> None:
        if layer._transpose:
            raise MXNetError("transpose conv has no int8 path")
        self._cfg = dict(kernel=layer._kernel, stride=layer._strides,
                         pad=layer._padding, dilate=layer._dilation,
                         num_filter=layer._channels,
                         num_group=layer._groups, layout=layer._layout)
        super().__init__(layer, in_range)

    def _geometry(self, nd: int):
        c = self._cfg
        return (qop._tuple(c["stride"] or 1, nd),
                qop._tuple(c["pad"] if c["pad"] is not None else 0, nd),
                qop._tuple(c["dilate"] or 1, nd))

    def _pack(self) -> i8.Packed:
        stride, pad, _ = self._geometry(self.wq.ndim - 2)
        return i8.pack_layer_weight(self.wq, stride, pad,
                                    self._cfg["num_group"],
                                    self._cfg["layout"])

    def forward(self, x):
        x = x.float()
        scale, step, b32 = self._constants(x)
        relu = self._activation == "relu"
        y = i8.conv_f32(x, self.wq, b32, scale, step,
                        *self._geometry(x.ndim - 2), self._cfg["num_group"],
                        self._cfg["layout"], relu, packed=self._packed())
        return self._activate(y, relu)

    def __repr__(self) -> str:
        return f"QuantizedConv({self._cfg['num_filter']}, int8)"


# ---------------------------------------------------------------------------
# quantize_net
# ---------------------------------------------------------------------------

def _target_layers(net: HybridBlock, exclude: Sequence[str]
                   ) -> List[Tuple[HybridBlock, str, HybridBlock, str]]:
    """(parent, child_name, layer, path) for every quantizable layer."""
    out = []

    def walk(block, prefix):
        for name, child in list(block._modules.items()):
            path = f"{prefix}{name}"
            quantizable = (isinstance(child, Dense) or
                           (isinstance(child, _Conv)
                            and not child._transpose))
            if quantizable and path not in exclude \
                    and child.weight.is_initialized:
                out.append((block, name, child, path))
            else:
                walk(child, path + ".")

    walk(net, "")
    return out


def quantize_net(net: HybridBlock, quantized_dtype: str = "int8",
                 exclude_layers: Optional[Sequence[str]] = None,
                 calib_data: Any = None, calib_mode: str = "naive",
                 num_calib_batches: Optional[int] = None,
                 logger: Optional[logging.Logger] = None) -> HybridBlock:
    """Post-training-quantize a gluon net for int8 inference.

    calib_mode: 'naive' (observed min/max), 'entropy' (KL-optimal
    threshold), or 'none' (per-batch dynamic ranges). ``calib_data``
    iterates input batches (tensors, or (data, label) tuples). The net is
    modified IN PLACE (quantizable children are swapped) and returned."""
    if quantized_dtype != "int8":
        raise MXNetError("only quantized_dtype='int8' is supported")
    if calib_mode not in ("naive", "entropy", "none"):
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    log = logger or logging.getLogger(__name__)
    targets = _target_layers(net, tuple(exclude_layers or ()))
    if not targets:
        raise MXNetError("no quantizable (Dense/Conv) layers found — "
                         "initialize the net first")

    ranges: Dict[str, Tuple[Any, Any]] = {}
    if calib_mode == "none":
        # dynamic: quantize_v2 takes each batch's min/max
        ranges = {path: (None, None) for _, _, _, path in targets}
    else:
        if calib_data is None:
            raise MXNetError(f"calib_mode={calib_mode!r} requires "
                             "calib_data")
        observers = {path: _Observer(calib_mode)
                     for _, _, _, path in targets}
        hooks = [layer.register_forward_pre_hook(
            lambda _m, args, _obs=observers[path]: _obs.update(
                args[0].detach()))
            for _, _, layer, path in targets]
        # calibration runs eagerly: a hybridized net would replay its
        # graphs and the hooks would never fire
        was_active = bool(getattr(net, "_active", False))
        if was_active:
            net.hybridize(active=False)
        try:
            with torch.no_grad():
                for i, batch in enumerate(calib_data):
                    if num_calib_batches is not None \
                            and i >= num_calib_batches:
                        break
                    data = batch[0] if isinstance(batch, (tuple, list)) \
                        else batch
                    net(data)
        finally:
            for h in hooks:
                h.remove()
            if was_active:
                net.hybridize(active=True)
        ranges = {p: obs.range() for p, obs in observers.items()}
        for p, r in ranges.items():
            log.info("calibrated %s: range (%.4g, %.4g)", p, *r)

    with torch.no_grad():
        for parent, name, layer, path in targets:
            cls = QuantizedDense if isinstance(layer, Dense) else \
                QuantizedConv
            parent._modules[name] = cls(layer, ranges[path])
    # compiled graphs of any block now run the old children
    for block in net.modules():
        if isinstance(block, HybridBlock):
            block._drop_graphs()
    return net
