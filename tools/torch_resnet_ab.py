#!/usr/bin/env python3
"""One ResNet-50 v1 training step of the PyTorch port in the tree at ROOT,
on one GPU: device busy time, the BatchNorm and conv kernels' shares of
it, and peak device memory, with ``MXNET_FUSE_BN_CONV`` on and off.

    python3 tools/torch_resnet_ab.py ROOT

ROOT is a checkout (or a ``git archive``) of the repository whose
``mxnet_tpu_torch`` and ``chip_smoke.py`` are measured; the step is
``chip_smoke.py``'s phase 6 (bf16 with f32 masters, B=128, 224x224,
weights from seed 0, SGD lr 0.1 momentum 0.9): three warm-up steps, three
timed by the host clock, one under torch.profiler after
``reset_peak_memory_stats``. To compare two commits, run it on each tree
in turns on one card (parent, change, change, parent). Each line starts
with ``AB``. Imports nothing of JAX.
"""
import os
import re
import sys
import time


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("AB: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mxnet_tpu_torch import _kernels, autograd
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from torch.profiler import ProfilerActivity, profile
    if not _kernels.__file__.startswith(root):
        print(f"AB: imported {_kernels.__file__}, not {root}", file=sys.stderr)
        return 1
    _kernels.build_all()
    dev = torch.device("cuda:0")
    params = cs.random_resnet_params(get_model("resnet50_v1", device="cpu"),
                                     seed=0)
    net = load_jax_params(get_model("resnet50_v1", device=dev), params,
                          dtype="bfloat16")
    rng = np.random.RandomState(0)      # bench.py's synthetic batch
    x = torch.from_numpy(rng.uniform(-1, 1, (128, 3, 224, 224))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, 1000, (128,)).astype(np.int64)) \
        .to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    conv = re.compile(r"(?<!flash_)(fwd_(tma|fma)<|dgrad_(tma|fma)<|"
                      r"wgrad_(rows|runs|f32|reduce)\b)")
    for knob in ("1", "0"):
        os.environ["MXNET_FUSE_BN_CONV"] = knob
        load_jax_params(net, params)
        tr = Trainer(net.collect_params(), "sgd",
                     {"learning_rate": 0.1, "momentum": 0.9,
                      "multi_precision": True})
        for _ in range(3):
            cs.resnet_step(autograd, net, loss_fn, tr, x, y)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            cs.resnet_step(autograd, net, loss_fn, tr, x, y)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) / 3 * 1e3
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cs.resnet_step(autograd, net, loss_fn, tr, x, y)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        times = cs.kernel_times(prof)
        busy = sum(times.values())
        bn_ms = sum(v for k, v in times.items() if re.search(r"\bbn::", k))
        conv_ms = sum(v for k, v in times.items() if conv.search(k))
        print(f"AB {os.path.basename(root)} fuse={knob}: busy {busy:.3f} ms, "
              f"batch norm kernels {bn_ms:.3f} ms, conv kernels "
              f"{conv_ms:.3f} ms, host step {step_ms:.3f} ms (mean of 3), "
              f"peak {peak:.3f} GiB; {cs.smi_line()}", flush=True)
        for k, v in sorted(times.items(), key=lambda kv: -kv[1])[:6]:
            print(f"AB   {v:8.3f} ms  {k[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
