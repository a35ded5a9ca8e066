"""ResNet v1/v2.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``: the same
blocks, stages, factories (``get_resnet``, ``resnet18_v1`` ...
``resnet152_v2``) and parameter names (``features.4.0.body.0.weight``).
Shapes are fixed at construction, so every layer is given its input
channels (the JAX package defers them to the first forward). With
``MXNET_FUSE_BN_CONV`` on, ``BottleneckV1`` runs both of its 1x1 junctions
through the prologue-fused kernels (``ops/cuda/conv_fused.py``): the (bn2,
relu, conv3) triple inside ``body``, and ``conv1`` of every block but the
first of a stage, which takes the previous block's epilogue ReLU as its
prologue (``PreActivation``). ResNet-50 v1 has 16 of the first and 12 of
the second. The fusion is numerically invisible. Native C-deployment
emission (``deploy_emit``) is not ported.
"""
from __future__ import annotations

from typing import Any, List

from ....base import MXNetError
from ....context import as_device
from ...block import HybridBlock, PreActivation
from ...parameter import data_or_none
from ...nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)
from ...nn.basic_layers import (_conv1x1_fusable, _has_hooks,
                                _sequential_forward)
from .... import npx

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


def _conv3x3(channels: int, stride: int, in_channels: int) -> Conv2D:
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels: int, stride: int, downsample: bool = False,
                 in_channels: int = 0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.body = HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(BatchNorm(in_channels=channels))
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(BatchNorm(in_channels=channels))
        if downsample:
            self.downsample = HybridSequential()
            self.downsample.add(Conv2D(channels, kernel_size=1,
                                       strides=stride, use_bias=False,
                                       in_channels=in_channels))
            self.downsample.add(BatchNorm(in_channels=channels))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(x)
        return npx.relu(out + residual)


class BottleneckV1(HybridBlock):
    """The deep-ResNet block. Under ``MXNET_FUSE_BN_CONV`` its (bn2, relu,
    conv3) triple fuses inside ``body``, and its epilogue ReLU is deferred
    (``PreActivation``) so the next block's conv1 takes it as a kernel
    prologue."""

    _consumes_preactivation = True

    def __init__(self, channels: int, stride: int, downsample: bool = False,
                 in_channels: int = 0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        mid = channels // 4
        self.body = HybridSequential()
        self.body.add(Conv2D(mid, kernel_size=1, strides=stride,
                             in_channels=in_channels))
        self.body.add(BatchNorm(in_channels=mid))
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid))
        self.body.add(BatchNorm(in_channels=mid))
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(channels, kernel_size=1, strides=1,
                             in_channels=mid))
        self.body.add(BatchNorm(in_channels=channels))
        if downsample:
            self.downsample = HybridSequential()
            self.downsample.add(Conv2D(channels, kernel_size=1,
                                       strides=stride, use_bias=False,
                                       in_channels=in_channels))
            self.downsample.add(BatchNorm(in_channels=channels))
        else:
            self.downsample = None

    def _block_out(self, x):
        """out + residual BEFORE the epilogue ReLU; ``x`` may be the
        previous sibling's deferred ``PreActivation``."""
        body = list(self.body._modules.values())
        z = None
        if isinstance(x, PreActivation):
            z = x.z
            if (npx.conv_fusion_enabled() and _conv1x1_fusable(body[0])
                    and not _has_hooks(self.body)):
                conv1 = body[0]
                h = npx.relu_conv1x1(z, conv1.weight.data(),
                                     data_or_none(conv1.bias))
                out = _sequential_forward(body[1:], h)
                xin = None      # the activated input, made only if needed
            else:
                xin = x.materialize()
                out = self.body(xin)
        else:
            xin = x
            out = self.body(xin)
        if xin is None:
            xin = npx.relu(z)
        residual = self.downsample(xin) if self.downsample is not None \
            else xin
        return out + residual

    def forward(self, x):
        return npx.relu(self._block_out(x))

    def _forward_deferred(self, x):
        """forward() without the epilogue ReLU, boxed, for a consuming
        sibling's fused conv1. Only _ResidualStage calls this."""
        return PreActivation(self._block_out(x))


class BasicBlockV2(HybridBlock):
    def __init__(self, channels: int, stride: int, downsample: bool = False,
                 in_channels: int = 0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.bn1 = BatchNorm(in_channels=in_channels)
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = BatchNorm(in_channels=channels)
        self.conv2 = _conv3x3(channels, 1, channels)
        if downsample:
            self.downsample = Conv2D(channels, 1, strides=stride,
                                     use_bias=False, in_channels=in_channels)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        out = npx.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(out)
        out = self.conv1(out)
        out = npx.relu(self.bn2(out))
        out = self.conv2(out)
        return out + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels: int, stride: int, downsample: bool = False,
                 in_channels: int = 0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        mid = channels // 4
        self.bn1 = BatchNorm(in_channels=in_channels)
        self.conv1 = Conv2D(mid, 1, strides=1, use_bias=False,
                            in_channels=in_channels)
        self.bn2 = BatchNorm(in_channels=mid)
        self.conv2 = _conv3x3(mid, stride, mid)
        self.bn3 = BatchNorm(in_channels=mid)
        self.conv3 = Conv2D(channels, 1, strides=1, use_bias=False,
                            in_channels=mid)
        if downsample:
            self.downsample = Conv2D(channels, 1, strides=stride,
                                     use_bias=False, in_channels=in_channels)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        out = npx.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(out)
        out = self.conv1(out)
        out = npx.relu(self.bn2(out))
        out = self.conv2(out)
        out = npx.relu(self.bn3(out))
        out = self.conv3(out)
        return out + residual


class _ResidualStage(HybridSequential):
    """A stage of residual blocks that drives the epilogue-ReLU deferral
    between siblings: with fusion on, each non-final block hands its
    successor the pre-activation sum. The stage always returns a
    materialized tensor; with fusion off it is exactly HybridSequential."""

    def forward(self, x, *args):
        children = list(self._modules.values())
        fuse = npx.conv_fusion_enabled() and not args
        for i, child in enumerate(children):
            defer = (fuse and i + 1 < len(children)
                     and hasattr(type(child), "_forward_deferred")
                     and getattr(type(children[i + 1]),
                                 "_consumes_preactivation", False)
                     and not _has_hooks(child, children[i + 1]))
            x = child._forward_deferred(x) if defer else child(x, *args)
            args = ()
        if isinstance(x, PreActivation):   # never leak the box
            x = x.materialize()
        return x


_BLOCK_V1 = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}
_BLOCK_V2 = {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}

# num_layers -> (block_type, layers-per-stage, channels-per-stage)
_RESNET_SPEC = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


def _make_layer(block, layers, channels, stride, in_channels):
    layer = _ResidualStage()
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels))
    return layer


class ResNetV1(HybridBlock):
    def __init__(self, block: type, layers: List[int], channels: List[int],
                 classes: int = 1000, thumbnail: bool = False,
                 in_channels: int = 3, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        self.features = HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, in_channels))
        else:
            self.features.add(Conv2D(channels[0], 7, strides=2, padding=3,
                                     use_bias=False, in_channels=in_channels))
            self.features.add(BatchNorm(in_channels=channels[0]))
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(3, 2, 1))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          stride, channels[i]))
        self.features.add(GlobalAvgPool2D())
        self.output = Dense(classes, in_units=channels[-1])

    def forward(self, x):
        x = self.features(x)
        return self.output(x.reshape(x.shape[0], -1))


class ResNetV2(HybridBlock):
    def __init__(self, block: type, layers: List[int], channels: List[int],
                 classes: int = 1000, thumbnail: bool = False,
                 in_channels: int = 3, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        self.features = HybridSequential()
        self.features.add(BatchNorm(scale=False, center=False,
                                    in_channels=in_channels))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, in_channels))
        else:
            self.features.add(Conv2D(channels[0], 7, strides=2, padding=3,
                                     use_bias=False, in_channels=in_channels))
            self.features.add(BatchNorm(in_channels=channels[0]))
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(3, 2, 1))
        c_in = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          stride, c_in))
            c_in = channels[i + 1]
        self.features.add(BatchNorm(in_channels=c_in))
        self.features.add(Activation("relu"))
        self.features.add(GlobalAvgPool2D())
        self.output = Dense(classes, in_units=channels[-1])

    def forward(self, x):
        x = self.features(x)
        return self.output(x.reshape(x.shape[0], -1))


def get_resnet(version: int, num_layers: int, pretrained: bool = False,
               device: Any = None, classes: int = 1000,
               **kwargs: Any) -> HybridBlock:
    """Build a zoo ResNet on ``device`` (``cuda:0`` by default; pass
    ``device="cpu"`` for the CPU). Parameters are zeros until
    ``initialize`` or :func:`~mxnet_tpu_torch.convert.load_jax_params`."""
    dev = as_device(device)
    if num_layers not in _RESNET_SPEC:
        raise MXNetError(f"invalid resnet depth {num_layers}; "
                         f"options: {sorted(_RESNET_SPEC)}")
    if pretrained:
        raise MXNetError("pretrained weights are not shipped; load them "
                         "with convert.load_jax_params")
    block_type, layers, channels = _RESNET_SPEC[num_layers]
    if version == 1:
        net = ResNetV1(_BLOCK_V1[block_type], layers, channels,
                       classes=classes, **kwargs)
    elif version == 2:
        net = ResNetV2(_BLOCK_V2[block_type], layers, channels,
                       classes=classes, **kwargs)
    else:
        raise MXNetError(f"invalid resnet version {version}")
    return net.to(dev)


def resnet18_v1(**kw): return get_resnet(1, 18, **kw)
def resnet34_v1(**kw): return get_resnet(1, 34, **kw)
def resnet50_v1(**kw): return get_resnet(1, 50, **kw)
def resnet101_v1(**kw): return get_resnet(1, 101, **kw)
def resnet152_v1(**kw): return get_resnet(1, 152, **kw)
def resnet18_v2(**kw): return get_resnet(2, 18, **kw)
def resnet34_v2(**kw): return get_resnet(2, 34, **kw)
def resnet50_v2(**kw): return get_resnet(2, 50, **kw)
def resnet101_v2(**kw): return get_resnet(2, 101, **kw)
def resnet152_v2(**kw): return get_resnet(2, 152, **kw)
