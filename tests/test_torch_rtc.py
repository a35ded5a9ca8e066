"""``mx.rtc`` of the port on the CPU: everything short of NVRTC and the card.

- signature parsing, ``PallasModule`` raising with guidance, a CPU NDArray
  (or any wrong argument) raising before anything launches, a missing
  NVRTC library raising with the paths it tried;
- ``bind``'s wrapper with a plain launcher put in the kernel's place: the
  outputs it allocates, the ``vjp`` it wires onto the tape, the refusal to
  differentiate a kernel without one. On ``tests/test_rtc.py``'s three
  kernels the result is held against ``mxnet_tpu.rtc.PallasModule`` in
  interpret mode (relative 1e-6, the tolerance of ``test_rtc.py``; the
  plain launchers compute in the same order); rtc_bias_gelu's gradient
  against torch autograd of its plain version (relative 1e-6).

The kernels themselves, compiled by NVRTC and launched on the card, are
``tests/test_torch_cuda.py``'s; their sources and plain versions are
``chip_smoke.py``'s.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import rtc as jrtc
from mxnet_tpu_torch import _nvrtc, rtc
from mxnet_tpu_torch.base import MXNetError


def test_parse_signature():
    ps = rtc.parse_signature("const float *x, float* y, float alpha, int n, "
                             "const __nv_bfloat16 * __restrict__ b, "
                             "int64_t k, __half h, uint8_t *m, char c")
    got = [(p.name, p.ctype, p.pointer, p.const) for p in ps]
    assert got == [("x", "float", True, True), ("y", "float", True, False),
                   ("alpha", "float", False, False),
                   ("n", "int", False, False),
                   ("b", "__nv_bfloat16", True, True),
                   ("k", "int64_t", False, False),
                   ("h", "__half", False, False),
                   ("m", "uint8_t", True, False),
                   ("c", "char", False, False)]
    assert [p.dtype for p in ps[:2]] == [torch.float32, torch.float32]
    assert ps[4].dtype == torch.bfloat16


@pytest.mark.parametrize("sig", ["float x y", "float **x", "long x",
                                 "const float *", ""])
def test_parse_signature_rejects(sig):
    with pytest.raises(MXNetError, match="cannot parse"):
        rtc.parse_signature(sig)


def test_scalars_take_their_declared_c_type():
    ps = rtc.parse_signature("float a, int n, __half h, __nv_bfloat16 b, "
                             "int64_t k")
    vals = [rtc._scalar_value(p, v) for p, v in
            zip(ps, (0.1, 7, 1.5, -2.0, 2 ** 40))]
    assert abs(vals[0].value - 0.1) < 1e-8 and type(vals[0]).__name__ == \
        "c_float"
    assert vals[1].value == 7 and vals[4].value == 2 ** 40
    assert vals[2].value == 0x3E00          # 1.5 in IEEE half
    assert vals[3].value == 0xC000          # -2.0 in bfloat16
    with pytest.raises(MXNetError, match="scalar"):
        rtc._scalar_value(ps[0], torch.ones(1))


def test_pallas_module_raises_with_guidance():
    with pytest.raises(MXNetError, match="CudaModule"):
        rtc.PallasModule(lambda x_ref, o_ref: None)


def _kernel(name="axpy"):
    # a kernel whose module was never compiled: every check below must
    # raise before the module is touched
    return rtc.CudaKernel(None, name, cs.RTC_SIGNATURES[name])


def test_cpu_ndarray_raises_and_never_launches():
    k = _kernel()
    before = rtc.launches["axpy"]
    with tmx.cpu():
        x, y, o = (tmx.nd.ones((4,)) for _ in range(3))
    for device in ("cpu", "cuda:0"):
        with pytest.raises(MXNetError):
            k.launch([x, y, o, 4], device, (1, 1, 1), (4, 1, 1))
    f = k.bind([((4,), "float32")], (1, 1, 1), (4, 1, 1), n=4)
    with pytest.raises(MXNetError):
        f(x, y)
    assert rtc.launches["axpy"] == before


def test_argument_checks():
    dev = torch.device("cuda", 0)
    p = rtc.parse_signature("float *x")[0]
    with pytest.raises(MXNetError, match="lies on cpu"):
        rtc._pointer_value(p, torch.ones(4), dev)
    with pytest.raises(MXNetError, match="pointer"):
        rtc._pointer_value(p, 3.0, dev)
    k = _kernel()
    with pytest.raises(MXNetError, match="takes 4 arguments"):
        k.launch([1.0], "cuda:0" if torch.cuda.is_available() else "cpu",
                 (1,), (1,))


def test_missing_nvrtc_names_the_paths_tried(monkeypatch, tmp_path):
    monkeypatch.setattr(_nvrtc, "_nvrtc_dirs", lambda: [str(tmp_path)])
    monkeypatch.setattr(_nvrtc, "_LIBS", {})
    with pytest.raises(MXNetError, match=str(tmp_path)):
        rtc.CudaModule("__global__ void k() {}")


# ---------------------------------------------------------------------------
# bind's wrapper with plain launchers, against PallasModule in interpret mode
# ---------------------------------------------------------------------------

def _plain(fn, n_in):
    """A launcher that writes fn(inputs) into the one output, in place."""
    def launch(args, device):
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        ts[n_in].copy_(fn(*ts[:n_in]))
    return launch


def _bound(name, out_shapes, fn, n_in, vjp=None, **scalars):
    return rtc.bind_launcher(name, rtc.parse_signature(
        cs.RTC_SIGNATURES[name]), out_shapes, _plain(fn, n_in), vjp, scalars)


def test_axpy_matches_pallas_module():
    def axpy_kernel(x_ref, y_ref, o_ref):
        o_ref[...] = 2.0 * x_ref[...] + y_ref[...]
    rng = onp.random.RandomState(0)
    x = rng.uniform(-1, 1, (64,)).astype("float32")
    y = rng.uniform(-1, 1, (64,)).astype("float32")
    want = jrtc.PallasModule(axpy_kernel, name="axpy").get_kernel(
        out_shapes=[((64,), "float32")])(jmx.np.array(x), jmx.np.array(y))
    f = _bound("axpy", [((64,), "float32")], cs.plain_axpy, 2, n=64)
    with tmx.cpu():
        got = f(tmx.np.array(x), tmx.np.array(y))
    assert got.shape == (64,) and str(got.dtype) == "float32"
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)


def test_scale_grid_matches_pallas_module():
    from jax.experimental import pallas as pl

    def scale_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 3.0
    x = onp.random.RandomState(1).uniform(-1, 1, (16, 128)).astype("float32")
    want = jrtc.PallasModule(scale_kernel).get_kernel(
        out_shapes=[((16, 128), "float32")], grid=(2,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)))(jmx.np.array(x))
    f = _bound("scale", [((16, 128), "float32")], cs.plain_scale, 1)
    with tmx.cpu():
        got = f(tmx.np.array(x))
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)


def _square_vjp(cot, x):
    return [cot * 2.0 * x]


def test_square_with_vjp_joins_the_tape_like_pallas_module():
    def square_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * x_ref[...]
    x0 = onp.linspace(-1, 1, 16).astype("float32")
    jf = jrtc.PallasModule(square_kernel).get_kernel(
        out_shapes=[((16,), "float32")], vjp=lambda cot, x: [cot * 2.0 * x])
    jx = jmx.np.array(x0)
    jx.attach_grad()
    with jmx.autograd.record():
        jy = jf(jx)
    jy.backward()
    f = _bound("square", [((16,), "float32")], cs.plain_square, 1,
               vjp=_square_vjp, n=16)
    with tmx.cpu():
        x = tmx.np.array(x0)
        x.attach_grad()
        g = x.grad
        with tmx.autograd.record():
            y = f(x)
        y.backward()
    onp.testing.assert_allclose(y.asnumpy(), jy.asnumpy(), rtol=1e-6)
    onp.testing.assert_allclose(x.grad.asnumpy(), jx.grad.asnumpy(),
                                rtol=1e-5)
    assert x.grad is g


def test_kernel_without_vjp_is_not_differentiable():
    f = _bound("square", [((4,), "float32")], cs.plain_square, 1, n=4)
    with tmx.cpu():
        x = tmx.np.array(onp.ones(4, dtype="float32"))
        x.attach_grad()
        with tmx.autograd.record():
            y = f(x)
        with pytest.raises(MXNetError, match="no graph"):
            y.backward()


def test_bind_checks_its_arguments():
    sig = rtc.parse_signature(cs.RTC_SIGNATURES["axpy"])
    noop = _plain(cs.plain_axpy, 2)
    with pytest.raises(MXNetError, match="scalars"):
        rtc.bind_launcher("axpy", sig, [((4,), "float32")], noop)
    with pytest.raises(MXNetError, match="declared"):
        rtc.bind_launcher("axpy", sig, [((4,), "int32")], noop,
                          scalars={"n": 4})
    with pytest.raises(MXNetError, match="fewer than"):
        rtc.bind_launcher("axpy", sig, [((4,), "float32")] * 4, noop,
                          scalars={"n": 4})
    f = rtc.bind_launcher("axpy", sig, [((4,), "float32")], noop,
                          scalars={"n": 4})
    with tmx.cpu(), pytest.raises(MXNetError, match="takes 2 inputs"):
        f(tmx.nd.ones((4,)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_gelu_vjp_matches_torch_autograd(dtype):
    """rtc_bias_gelu's wrapper (chip_smoke.rtc_bias_gelu) with the plain
    versions of both kernels: x.grad and b.grad against torch autograd of
    the plain forward."""
    rng = onp.random.RandomState(2)
    x0 = rng.standard_normal((6, 8)).astype("float32")
    b0 = rng.standard_normal((8,)).astype("float32")

    def plain_kernel(fn, n_in):
        k = rtc.CudaKernel(None, "k", "float *a")
        k.launch = lambda args, device, grid, block, shared_mem=0: \
            _plain(fn, n_in)(args, device)
        return k
    ctype = cs.GELU_TYPES[dtype]
    kernels = {f"rtc_bias_gelu<{ctype}>": plain_kernel(cs.plain_bias_gelu, 2),
               f"rtc_bias_gelu_grad<{ctype}>":
               plain_kernel(cs.plain_bias_gelu_grad, 3)}
    for name in kernels:
        kernels[name].name = name
        kernels[name].params = rtc.parse_signature(cs.RTC_SIGNATURES[name])
    with tmx.cpu():
        x = tmx.nd.array(x0, dtype=dtype)
        b = tmx.nd.array(b0, dtype=dtype)
        x.attach_grad()
        b.attach_grad()
        with tmx.autograd.record():
            y = cs.rtc_bias_gelu(kernels, x, b)
            s = y.sum()
        s.backward()
    xt = x._data.detach().clone().requires_grad_()
    bt = b._data.detach().clone().requires_grad_()
    u = (xt + bt).float()
    ref = 0.5 * u * (1 + torch.erf(u * cs.SQRT1_2))
    ref.sum().backward()
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert str(y.dtype) == dtype
    assert cs.rel_np(y.asnumpy(), ref.detach().to(xt.dtype).float().numpy()) \
        <= tol
    assert cs.rel_np(x.grad.asnumpy(), xt.grad.float().numpy()) <= tol
    assert cs.rel_np(b.grad.asnumpy(), bt.grad.float().numpy()) <= tol
