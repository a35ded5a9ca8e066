"""Basic layers: HybridSequential, Dense, Dropout, BatchNorm, LayerNorm,
Embedding, Flatten, and the BatchNorm -> relu -> 1x1-conv junction matcher.

Counterpart of the same classes and helpers (``_has_hooks``,
``_conv1x1_fusable``, ``_fusable_bn_relu_conv``, ``_sequential_forward``)
in ``mxnet_tpu/gluon/nn/basic_layers.py``, with the same parameter names
and layouts (Dense weight is (units, in_units); LayerNorm has gamma/beta;
BatchNorm has gamma, beta, running_mean, running_var and stat_shift).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ... import npx
from ...base import MXNetError
from ..block import HybridBlock
from ..parameter import Parameter, data_or_none

__all__ = ["HybridSequential", "Dense", "Dropout", "BatchNorm", "LayerNorm",
           "Embedding", "Flatten"]


def _has_hooks(*blocks) -> bool:
    """Fused paths bypass the children's ``__call__``, so a registered
    forward hook disqualifies fusion (hooks fire the same either way)."""
    return any(b._forward_pre_hooks or b._forward_hooks for b in blocks)


def _conv1x1_fusable(conv) -> bool:
    """Can this conv be the GEMM of a prologue-fused junction? (1x1, stride
    1, no padding, NCHW, no groups, dilation or activation, stock forward,
    no hooks: the contract of ``ops/cuda/conv_fused.py``.) Shared by the
    HybridSequential triple matcher and the ResNet epilogue deferral."""
    from .conv_layers import Conv2D, _Conv
    return (isinstance(conv, Conv2D)
            and type(conv).forward is _Conv.forward
            and conv._kernel == (1, 1) and conv._strides == (1, 1)
            and conv._padding == (0, 0) and conv._dilation == (1, 1)
            and conv._groups == 1 and conv._layout == "NCHW"
            and not conv._activation and not _has_hooks(conv))


def _fusable_bn_relu_conv(children, i, x) -> bool:
    """Is ``children[i:i+3]`` a (BatchNorm, relu, 1x1-s1 Conv2D) junction
    the fused kernels take whole, for this 4-d input? The JAX package also
    asks its TPU traffic rule (``fusion_profitable``); the port does not:
    every such junction fuses."""
    if i + 3 > len(children):
        return False
    bn, act, conv = children[i], children[i + 1], children[i + 2]
    from .activations import Activation
    if not (isinstance(bn, BatchNorm) and type(bn).forward is BatchNorm.forward
            and isinstance(act, Activation)
            and type(act).forward is Activation.forward
            and _conv1x1_fusable(conv)):
        return False
    if bn._axis != 1 or act._act != "relu" or _has_hooks(bn, act):
        return False
    return isinstance(x, torch.Tensor) and x.ndim == 4


def _sequential_forward(children, x: Any, args: tuple = ()) -> Any:
    """The HybridSequential chain with junction fusion; also runs the
    children suffix after a fused head (model_zoo resnet BottleneckV1)."""
    fuse = npx.conv_fusion_enabled() and not args
    i = 0
    while i < len(children):
        if fuse and _fusable_bn_relu_conv(children, i, x):
            x = children[i].fused_conv_forward(x, children[i + 2])
            i += 3
            continue
        x = children[i](x, *args)
        args = ()
        i += 1
    return x


class HybridSequential(HybridBlock):
    """Children run in order; they are named "0", "1", ...

    With ``MXNET_FUSE_BN_CONV`` on, consecutive ``BatchNorm -> relu -> 1x1
    Conv2D`` children run as one prologue-fused GEMM: the normalized and
    activated tensor never exists in device memory."""

    def add(self, *blocks: HybridBlock) -> None:
        for b in blocks:
            self.register_child(b)

    def forward(self, x: Any, *args: Any) -> Any:
        return _sequential_forward(list(self._modules.values()), x, args)

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, key):
        items = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*items[key])
            return net
        return items[key]

    def __iter__(self):
        return iter(self._modules.values())


class Dense(HybridBlock):
    """Fully-connected layer: out = act(x·Wᵀ + b)."""

    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True, flatten: bool = True,
                 dtype: Any = "float32", weight_initializer: Any = None,
                 bias_initializer: Any = "zeros", in_units: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = Parameter("weight", shape=(units, in_units),
                                dtype=dtype, init=weight_initializer)
        self.bias = Parameter("bias", shape=(units,), dtype=dtype,
                              init=bias_initializer) if use_bias else None

    def forward(self, x):
        out = npx.fully_connected(x, self.weight.data(),
                                  data_or_none(self.bias),
                                  num_hidden=self._units,
                                  no_bias=self.bias is None,
                                  flatten=self._flatten)
        if self._activation:
            out = npx.activation(out, self._activation)
        return out


class Dropout(HybridBlock):
    """Dropout, active in training (``autograd.record()``); ``axes``: the
    mask is shared along these axes."""

    def __init__(self, rate: float, axes: Tuple[int, ...] = (),
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return npx.dropout(x, self._rate, axes=self._axes)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` with gamma/beta. ``center`` and
    ``scale`` are accepted, and gamma and beta apply either way, as in the
    JAX package."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 beta_initializer: Any = "zeros",
                 gamma_initializer: Any = "ones", in_channels: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=gamma_initializer)
        self.beta = Parameter("beta", shape=(in_channels,),
                              init=beta_initializer)

    def forward(self, x):
        return npx.layer_norm(x, self.gamma.data(), self.beta.data(),
                              axis=self._axis, eps=self._epsilon)


class Embedding(HybridBlock):
    """Index → vector lookup table. ``sparse_grad=True`` (a row-sparse
    weight gradient) is not ported."""

    def __init__(self, input_dim: int, output_dim: int,
                 dtype: Any = "float32", weight_initializer: Any = None,
                 sparse_grad: bool = False, **kwargs: Any) -> None:
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True): row-sparse "
                             "gradients are not ported yet (ROADMAP Queue A "
                             "10)")
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter("weight", shape=(input_dim, output_dim),
                                dtype=dtype, init=weight_initializer)

    def forward(self, x):
        return npx.embedding(x, self.weight.data(), input_dim=self._input_dim,
                             output_dim=self._output_dim)


class BatchNorm(HybridBlock):
    """Batch normalization with moving statistics.

    Training statistics are one pass about ``stat_shift``, the previous
    batch's mean (``ops/cuda/batch_norm.py``); the layer's first
    training forward, while ``stat_shift`` is all zeros, takes centered
    statistics instead. The moving averages and ``stat_shift`` are updated
    in place after each training forward, outside autograd. The port runs
    eagerly, so the JAX package's graph invalidation has no counterpart."""

    def __init__(self, axis: int = 1, momentum: float = 0.9,
                 epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, use_global_stats: bool = False,
                 beta_initializer: Any = "zeros",
                 gamma_initializer: Any = "ones",
                 running_mean_initializer: Any = "zeros",
                 running_variance_initializer: Any = "ones",
                 in_channels: int = 0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=gamma_initializer,
                               grad_req="write" if scale else "null")
        self.beta = Parameter("beta", shape=(in_channels,),
                              init=beta_initializer,
                              grad_req="write" if center else "null")
        self.running_mean = Parameter("running_mean", shape=(in_channels,),
                                      init=running_mean_initializer,
                                      grad_req="null")
        self.running_var = Parameter("running_var", shape=(in_channels,),
                                     init=running_variance_initializer,
                                     grad_req="null")
        # runtime-only: the previous batch's mean, always near E[x], so the
        # shifted one-pass variance never cancels catastrophically
        self.stat_shift = Parameter("stat_shift", shape=(in_channels,),
                                    init="zeros", grad_req="null",
                                    persistent=False)
        self._stats_virgin: Optional[bool] = None
        self._virgin_for: Any = None

    def _resolve_virgin_stats(self) -> bool:
        """Is ``stat_shift`` still all zeros? Read from the device once and
        cached against the buffer's identity and version, so a load or a
        cast (which rewrite it) asks again."""
        sh = self.stat_shift.data()
        key = (sh.data_ptr(), sh._version)
        if self._virgin_for != key:
            self._virgin_for = key
            self._stats_virgin = not bool(sh.detach().any())
        return self._stats_virgin

    def _tensors(self):
        """gamma, beta, running_mean, running_var as tensors."""
        return (self.gamma.data(), self.beta.data(),
                self.running_mean.data(), self.running_var.data())

    def _pre(self) -> Tuple[bool, bool]:
        """(training, virgin-shift), shared by forward() and the fused path."""
        from ... import autograd
        training = autograd.is_training() and not self._use_global_stats
        return training, training and self._resolve_virgin_stats()

    def forward(self, x):
        training, virgin = self._pre()
        out, batch_mean, batch_var = npx.batch_norm(
            x, *self._tensors(), eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale, axis=self._axis,
            use_global_stats=self._use_global_stats,
            stats="centered" if virgin else None,
            shift=self.stat_shift.data())
        self._post(training, batch_mean, batch_var)
        return out

    def fused_conv_forward(self, x, conv):
        """``conv(relu(bn(x)))`` through the prologue-fused kernels: the
        statistics contract of forward(), with the apply, the ReLU and the
        1x1 conv as one GEMM."""
        training, virgin = self._pre()
        out, batch_mean, batch_var = npx.batch_norm_relu_conv1x1(
            x, *self._tensors(), conv.weight.data(),
            conv_bias=data_or_none(conv.bias), eps=self._epsilon,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats,
            stats="centered" if virgin else None,
            shift=self.stat_shift.data())
        self._post(training, batch_mean, batch_var)
        return out

    @torch.no_grad()
    def _post(self, training: bool, batch_mean, batch_var) -> None:
        if not training:
            return
        m = self._momentum
        rm, rv, sh = (p.data() for p in (self.running_mean, self.running_var,
                                         self.stat_shift))
        rm.copy_(m * rm + (1 - m) * batch_mean.detach())
        rv.copy_(m * rv + (1 - m) * batch_var.detach())
        sh.copy_(batch_mean.detach().to(sh.dtype))
        self._stats_virgin = False
        self._virgin_for = (sh.data_ptr(), sh._version)

    def extra_repr(self) -> str:
        return f"axis={self._axis}, momentum={self._momentum}"


class Flatten(HybridBlock):
    """Collapse all but the batch axis."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)
