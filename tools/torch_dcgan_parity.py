#!/usr/bin/env python3
"""How far MXNet's DCGAN iteration at B = 8 (``chip_smoke.py`` phase 11's
parity, f32) moves with rounding alone: the port on the CPU run with 1, 2,
3, 4 and 8 threads (each thread count sums in its own order), each against
the 1-thread run, as the phase compares the card with the CPU.

    python3 tools/torch_dcgan_parity.py

For each thread count: the losses' relative error, the worst gradient's
relative Frobenius error and its name, the D gradients whose sign
differs, and D's Adam step held as the phase holds it
(``chip_smoke.dcgan_d_step``: the worst update's relative error over the
settled elements, and the unsettled ones), once with G's step through
each run's own D after its Adam step and once through the 1-thread run's
D (as the phase takes it). Adam's
first step moves a weight by about lr times the sign of its gradient, so
a D gradient within rounding of 0 can move G's gradients far past the
phase's 1e-3. Needs no GPU; imports nothing of JAX.
"""
import os
import sys


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch.gluon import nn
    netG, netD = cs.dcgan_nets(nn, **cs.DCGAN)
    params = (cs.dcgan_weights(netG, 0), cs.dcgan_weights(netD, 1))
    real, noise = cs.dcgan_data(torch, cs.B_DCGAN_PARITY, 11, "cpu")
    before = {k: torch.from_numpy(v) for k, v in params[1].items()}
    base, d_after = None, None
    for shared in (False, True):
        for threads in (1, 2, 3, 4, 8):
            torch.set_num_threads(threads)
            nets = cs.dcgan_setup(torch, "cpu", params)
            stepped = {}
            eD, eG, gD, gG = cs.dcgan_iteration(
                torch, nets, real, noise, grads=True,
                d_after=d_after if shared and threads > 1 else None,
                d_step=stepped)
            if threads == 1:
                base = (eD, eG, gD, gG)
                d_after = {k: p.data().detach().clone() for k, p in
                           nets[1].collect_params().items()
                           if p.grad_req != "null"}
                continue
            loss = max(cs.rel(eD, base[0]), cs.rel(eG, base[1]))
            worst = max((cs.rel(g[k], b[k]), k) for g, b in
                        ((gD, base[2]), (gG, base[3])) for k in b)
            flips = sum(int(((gD[k] > 0) != (base[2][k] > 0)).sum())
                        for k in gD)
            step = cs.dcgan_d_step(before, stepped, d_after, gD, base[2])
            print(f"{'shared D' if shared else 'own D'}, {threads} threads "
                  f"against 1: losses rel {loss:.3e}, worst gradient "
                  f"{worst[1]} rel {worst[0]:.3e}, D gradient signs "
                  f"differing {flips}, D's step: worst update {step[1]} rel "
                  f"{step[0]:.3e}, unsettled {step[2]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
