"""The slice as a whole: MXNet's Gluon DCGAN (``example/gluon/dc_gan``:
``nn.Sequential`` of ``Conv2DTranspose`` / ``Conv2D``, ``BatchNorm``,
``Activation``, ``LeakyReLU(0.2)``; ``SigmoidBinaryCrossEntropyLoss``; two
Adam trainers at lr 2e-4, beta1 0.5) trained one iteration and a second
forward in the port and in the JAX package on the CPU, from the same
weights (the convolutions' N(0, 0.02), the BatchNorms' own ones and zeros),
images and noise.

An iteration is the example's loop: D on a real batch (label 1) and on
``G(z).detach()`` (label 0), ``trainerD.step``; then G through D (label
1), ``trainerG.step``. At nz = 16, ngf = ndf = 8, B = 4, 64x64: D's and
G's per-sample losses rtol=1e-4 (atol=1e-6), every gradient of D's step and
of G's step within relative Frobenius error 1e-4, and the second
iteration's losses rtol=1e-4 after the Adam steps.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import load_jax_params

NZ, NGF, NDF, NC, B = 16, 8, 8, 3, 4
LOSS = dict(rtol=1e-4, atol=1e-6)


def dcgan(gl, nz=NZ, ngf=NGF, ndf=NDF, nc=NC):
    """The example's generator and discriminator, built from ``gl`` (either
    package's ``gluon``), shapes given (the port does not defer them)."""
    nn = gl.nn
    netG = nn.Sequential()
    cin = nz
    for i, c in enumerate((ngf * 8, ngf * 4, ngf * 2, ngf)):
        netG.add(nn.Conv2DTranspose(c, 4, 1 if i == 0 else 2,
                                    0 if i == 0 else 1, use_bias=False,
                                    in_channels=cin),
                 nn.BatchNorm(in_channels=c), nn.Activation("relu"))
        cin = c
    netG.add(nn.Conv2DTranspose(nc, 4, 2, 1, use_bias=False,
                                in_channels=ngf), nn.Activation("tanh"))
    netD = nn.Sequential()
    netD.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False, in_channels=nc),
             nn.LeakyReLU(0.2))
    cin = ndf
    for c in (ndf * 2, ndf * 4, ndf * 8):
        netD.add(nn.Conv2D(c, 4, 2, 1, use_bias=False, in_channels=cin),
                 nn.BatchNorm(in_channels=c), nn.LeakyReLU(0.2))
        cin = c
    netD.add(nn.Conv2D(1, 4, 1, 0, use_bias=False, in_channels=ndf * 8))
    return netG, netD


def weights(net, seed):
    """The example's initialization: convolutions N(0, 0.02), the
    BatchNorms' gamma 1, beta 0 and running statistics 0 / 1."""
    rng = onp.random.RandomState(seed)
    fill = {"gamma": 1.0, "running_var": 1.0}
    return {k: (rng.normal(0, 0.02, p.shape) if k.endswith("weight") else
                onp.full(p.shape, fill.get(k.rsplit(".", 1)[1], 0.0)))
            .astype("float32") for k, p in net.collect_params().items()}


def _rel(a, b):
    return float(onp.linalg.norm(a - b) / max(onp.linalg.norm(b), 1e-30))


def _iteration(pkg, record, backward, netG, netD, trD, trG, loss, real,
               noise, ones, zeros):
    """One iteration of the example's loop; returns errD, errG and the
    gradients of D's step and of G's step (numpy, by parameter name)."""
    def grads(net):
        return {k: to_np(p.grad()) for k, p in net.collect_params().items()
                if p.grad_req != "null"}

    to_np = (lambda t: t.asnumpy()) if pkg == "jax" else \
        (lambda t: t.detach().numpy())
    with record():
        errD_real = loss(netD(real).reshape((-1, 1)), ones)
        fake = netG(noise)
        errD_fake = loss(netD(fake.detach()).reshape((-1, 1)), zeros)
        errD = errD_real + errD_fake
    backward(errD)
    gD = grads(netD)
    trD.step(B)
    with record():
        errG = loss(netD(netG(noise)).reshape((-1, 1)), ones)
    backward(errG)
    gG = grads(netG)
    trG.step(B)
    return to_np(errD), to_np(errG), gD, gG


def _run_jax(pG, pD, real, noise):
    netG, netD = dcgan(mx.gluon)
    for net, p in ((netG, pG), (netD, pD)):
        net.initialize()
        for k, v in net.collect_params().items():
            v.set_data(mx.np.array(p[k]))
    hp = {"learning_rate": 2e-4, "beta1": 0.5}
    trD = mx.gluon.Trainer(netD.collect_params(), "adam", dict(hp))
    trG = mx.gluon.Trainer(netG.collect_params(), "adam", dict(hp))
    loss = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    ones, zeros = mx.np.ones((B,)), mx.np.zeros((B,))
    x, z = mx.np.array(real), mx.np.array(noise)
    args = (netG, netD, trD, trG, loss, x, z, ones, zeros)
    first = _iteration("jax", mx.autograd.record, lambda h: h.backward(),
                       *args)
    second = _iteration("jax", mx.autograd.record, lambda h: h.backward(),
                        *args)
    return first, second


def _run_port(pG, pD, real, noise):
    netG, netD = dcgan(gluon)
    load_jax_params(netG.to("cpu"), pG)
    load_jax_params(netD.to("cpu"), pD)
    hp = {"learning_rate": 2e-4, "beta1": 0.5}
    trD = gluon.Trainer(netD.collect_params(), "adam", dict(hp))
    trG = gluon.Trainer(netG.collect_params(), "adam", dict(hp))
    loss = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    ones, zeros = torch.ones(B), torch.zeros(B)
    args = (netG, netD, trD, trG, loss, torch.from_numpy(real),
            torch.from_numpy(noise), ones, zeros)
    first = _iteration("port", autograd.record, autograd.backward, *args)
    second = _iteration("port", autograd.record, autograd.backward, *args)
    return first, second


def test_dcgan_iteration_matches_jax():
    netG, netD = dcgan(mx.gluon)
    pG, pD = weights(netG, 0), weights(netD, 1)
    rng = onp.random.RandomState(2)
    real = rng.uniform(-1, 1, (B, NC, 64, 64)).astype("float32")
    noise = rng.normal(0, 1, (B, NZ, 1, 1)).astype("float32")
    (jD, jG, jgD, jgG), (jD2, jG2, _, _) = _run_jax(pG, pD, real, noise)
    (tD, tG, tgD, tgG), (tD2, tG2, _, _) = _run_port(pG, pD, real, noise)
    assert tD.shape == tG.shape == (B,)
    onp.testing.assert_allclose(tD, jD, **LOSS)
    onp.testing.assert_allclose(tG, jG, **LOSS)
    for want, got in ((jgD, tgD), (jgG, tgG)):
        assert sorted(got) == sorted(want)
        worst = max((_rel(got[k], want[k]), k) for k in want)
        assert worst[0] <= 1e-4, worst
    # the second iteration starts from the Adam steps' weights
    onp.testing.assert_allclose(tD2, jD2, **LOSS)
    onp.testing.assert_allclose(tG2, jG2, **LOSS)
    assert not onp.allclose(tD2, tD) and not onp.allclose(tG2, tG)
