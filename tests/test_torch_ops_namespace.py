"""The port's operator namespaces against the JAX package's on the CPU.

- ``mx.ops`` (C16): every name of ``mxnet_tpu.ops.__all__`` (the ``__all__``
  of ``nn``, ``transformer``, ``quantization`` and ``boxes``) resolves on
  the port's ``mxnet_tpu_torch.ops``, in the same order, but ``rnn``, which
  raises :class:`MXNetError` naming ROADMAP Queue A 9.
- The 9 quantized and 6 box operators: ``mx.nd.<name>``,
  ``mx.nd.contrib.<name>`` and ``mx.nd.contrib._contrib_<name>`` in both
  packages, and ``mx.nd._contrib_<name>`` on the port, are one registered
  NDArray operator; ``mx.npx`` holds the quantized ones. Called on
  NDArrays, an operator returns what the JAX package's does on the same
  input (codes and ranges to the bit).
- ``mx.nd``'s CamelCase aliases and ``Custom`` raise ``MXNetError`` naming
  Queue A 7; ``mx.contrib`` holds ``quantization``, and its other modules
  raise naming Queue A 15.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest

import mxnet_tpu as mx
import mxnet_tpu.contrib  # noqa: F401
import mxnet_tpu.ops as jops
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import boxes as jboxes
from mxnet_tpu.ops import quantization as jquant
from mxnet_tpu_torch.base import MXNetError

NEW_OPS = list(jquant.__all__) + list(jboxes.__all__)


def test_ops_namespace_walks_the_jax_package():
    assert len(jops.__all__) == 74 and len(NEW_OPS) == 15
    assert tmx.ops.__all__ == [n for n in jops.__all__ if n != "rnn"]
    for name in jops.__all__:
        if name == "rnn":
            with pytest.raises(MXNetError, match=r"Queue A 9\b"):
                getattr(tmx.ops, name)
            continue
        assert callable(getattr(tmx.ops, name)), name
    for name in ("layer_norm", "batch_norm", "fully_connected",
                 "multi_head_attention", "quantized_conv", "box_nms"):
        assert getattr(tmx.ops, name) is getattr(
            getattr(tmx.ops, {"multi_head_attention": "transformer",
                              "quantized_conv": "quantization",
                              "box_nms": "boxes"}.get(name, "nn")), name)
    with pytest.raises(AttributeError):
        tmx.ops.no_such_op


@pytest.mark.parametrize("name", NEW_OPS)
def test_new_operators_resolve_in_every_namespace(name):
    op = tmx.nd.get_op(name)
    assert getattr(tmx.nd, name) is op
    assert getattr(tmx.nd, "_contrib_" + name) is op
    assert getattr(tmx.nd.contrib, name) is op
    assert getattr(tmx.nd.contrib, "_contrib_" + name) is op
    assert getattr(mx.nd, name) is getattr(mx.nd.contrib, name)
    assert getattr(mx.nd.contrib, "_contrib_" + name) is \
        getattr(mx.nd.contrib, name)
    if name in jquant.__all__:
        assert name in tmx.npx.__all__ and name in mx.npx.__all__
        assert getattr(tmx.npx, name) is getattr(tmx.ops, name)


def test_ndarray_operators_equal_jax():
    x = onp.random.RandomState(0).randn(3, 8).astype("float32")
    got = tmx.nd.contrib.quantize_v2(tmx.nd.array(x, ctx=tmx.cpu()),
                                     out_type="int8")
    want = mx.nd.contrib.quantize_v2(mx.np.array(x), out_type="int8")
    for g, w in zip(got, want):
        assert isinstance(g, tmx.nd.NDArray)
        onp.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    a = onp.array([[0, 0, 2, 2], [1, 1, 3, 3]], "float32")
    onp.testing.assert_allclose(
        tmx.nd.box_iou(tmx.nd.array(a, ctx=tmx.cpu()),
                       tmx.nd.array(a, ctx=tmx.cpu())).asnumpy(),
        mx.nd.box_iou(mx.np.array(a), mx.np.array(a)).asnumpy(), rtol=1e-6)


def test_unported_names_name_their_queue_items():
    for name in ("Convolution", "FullyConnected", "BatchNorm", "Custom"):
        with pytest.raises(MXNetError, match=r"Queue A 7\b"):
            getattr(tmx.nd, name)
    with pytest.raises(AttributeError):
        tmx.nd.no_such_op
    with pytest.raises(AttributeError):
        tmx.nd.contrib.no_such_op
    assert tmx.contrib.quantization.quantize_net is not None
    for name in ("onnx", "text", "svrg", "tensorboard", "hf"):
        with pytest.raises(MXNetError, match=r"Queue A 15\b"):
            getattr(tmx.contrib, name)
    with pytest.raises(AttributeError):
        tmx.contrib.no_such_module
