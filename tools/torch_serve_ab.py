#!/usr/bin/env python3
"""BERT-base served by the PyTorch port in the tree at ROOT, on one GPU:
the in-process graph server's requests a second over repeated bursts, and
a direct forward, eager and replayed.

    python3 tools/torch_serve_ab.py ROOT [BURSTS]

ROOT is a checkout (or a ``git archive``) of the repository whose
``mxnet_tpu_torch`` and ``chip_smoke.py`` are measured. The model and the
traffic are ``chip_smoke.py``'s phase 4: BERT-base (12 layers, 768 units,
12 heads) in bf16 with weights from seed 0, batch buckets 1, 2, 4, 8 and
length buckets 128 / 512, the 16 requests of lengths 16-512. A graph
server (every bucket captured by its warm-up) answers BURSTS bursts
(default 20) of the 16 requests sent together: requests a second and
batches of each burst. Then a direct forward at B=8, T=512 is timed by
CUDA events, eager and replayed, mean of 50 calls after 5, three times
each. Where the tree has the registered forward op
(``mxnet_tpu_torch::flash_attention_fwd``), one layer's forward launch at
the served shape (B=8, H=12, T=512, D=64, bf16, key padding) is timed by
the host clock over 2000 calls, through the op and through the launcher
it wraps (the path of a tree without the op), in turns, five times each:
the launch path's host cost, which an eager forward pays 12 times a
batch. To compare two commits, run it on each tree in turns on one card
(parent, change, change, parent). Each line starts with ``AB``. Imports
nothing of JAX.
"""
import os
import sys
import threading
import time


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    bursts = int(sys.argv[2]) if len(sys.argv) == 3 else 20
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("AB: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.block import HybridBlock
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert
    from mxnet_tpu_torch.serving import BucketPolicy, ModelServer, ServedModel
    if not _kernels.__file__.startswith(root):
        print(f"AB: imported {_kernels.__file__}, not {root}", file=sys.stderr)
        return 1

    class Encode(HybridBlock):
        def __init__(self, bert):
            super().__init__()
            self.bert = bert

        def forward(self, tokens, valid_length):
            return self.bert(tokens, None, valid_length)

    dev = torch.device("cuda:0")
    bert = get_bert("bert_12_768_12", vocab_size=30522, max_length=512,
                    dropout=0.1, device="cpu")
    net = Encode(load_jax_params(bert, cs.random_bert_params(bert, seed=0)))
    net = net.cast(torch.bfloat16).to(dev)
    net.hybridize()
    model = ServedModel.from_block(net, [((512,), np.int32), ((), np.int32)],
                                   device=dev)
    policy = BucketPolicy(batch_buckets=(1, 2, 4, 8), pad_axis=0,
                          length_buckets=(128, 512))
    rng = np.random.RandomState(1)
    lengths = [int(x) for x in rng.randint(16, 513, size=16)]
    lengths[0], lengths[1] = 16, 512
    samples = [(rng.randint(0, 30522, size=L).astype(np.int32),
                np.int32(L)) for L in lengths]
    print(f"AB: {root}: card {cs.smi_line()}", flush=True)

    rates, batches = [], []
    with ModelServer(model, policy=policy, warmup=True,
                     timeout_ms=5) as server:
        for _ in range(bursts):
            b0 = server.stats["batches"]
            threads = [threading.Thread(target=server.infer, args=s,
                                        kwargs={"timeout": 300.0})
                       for s in samples]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            rates.append(len(samples) / (time.perf_counter() - t0))
            batches.append(server.stats["batches"] - b0)
    q = np.percentile(rates, [25, 50, 75])
    print(f"AB: graph server, {bursts} bursts of {len(samples)} requests: "
          f"req/s median {q[1]:.2f} (quartiles {q[0]:.2f} / {q[2]:.2f}), "
          f"batches a burst {sorted(set(batches))}; each: "
          f"{[round(r, 2) for r in rates]}", flush=True)

    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, 30522, (8, 512), generator=gen).to(dev)
    vl = torch.randint(16, 513, (8,), generator=gen).to(dev)
    for mode in ("eager", "replayed"):
        net.hybridize(mode == "replayed")
        with torch.inference_mode():
            ms = [cs.cuda_time_ms(lambda: net(tok, vl), iters=50, warmup=5)
                  for _ in range(3)]
        print(f"AB: direct forward ({mode}) B=8 T=512 bf16: "
              f"{[round(m, 4) for m in ms]} ms (CUDA events, mean of 50)",
              flush=True)
    from mxnet_tpu_torch.ops.cuda import attention as attn
    if hasattr(attn, "flash_attention_fwd"):
        launch_path(torch, attn, dev)
    return 0


def launch_path(torch, attn, dev, calls=2000, rounds=5):
    """Host µs a call of the forward's launch through the registered op
    and through the launcher it wraps, in turns."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(8, 512, 12, 64, generator=g).to(dev, torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    keep = torch.arange(512)[None, :] < torch.randint(
        16, 513, (8,), generator=g)[:, None]
    bias = torch.where(keep, 0.0, -3e38)[:, None, None, :].to(
        dev, torch.bfloat16)

    def op():
        attn._flash_forward(q, k, v, bias, 0.125, False)

    def launcher():
        out, lse = attn._fwd_outputs(q)
        attn._launch_fwd(q, k, v, bias, None, 0.0, out, lse, 0.125, False)

    times = {"op": [], "launcher": []}
    with torch.inference_mode():
        for fn in (op, launcher):
            fn()
        torch.cuda.synchronize()
        for _ in range(rounds):
            for name, fn in (("op", op), ("launcher", launcher)):
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) / calls * 1e6)
    print(f"AB: forward launch path, host µs a call (B=8 H=12 T=512 D=64 "
          f"bf16, {calls} calls, {rounds} rounds in turns): registered op "
          f"{[round(t, 2) for t in times['op']]}, launcher "
          f"{[round(t, 2) for t in times['launcher']]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
