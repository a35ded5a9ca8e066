#!/usr/bin/env python3
"""BatchNorm's two reductions of the tree at ROOT under other settings of
their plan, timed on one GPU at DCGAN's and ResNet-50's shapes.

    python3 tools/torch_bn_plans.py ROOT [SETTING[,SETTING...] ...]

Each argument is one variant, a comma-separated list of KEY=VALUE of
``bn_reduce_plan``'s constants (``-`` alone: the tree's own plan):
``blocks`` (``_REDUCE_BLOCKS``, the most blocks the grid aims for),
``floor`` (``_MIN_REDUCE_BLOCKS``, the fewest), ``cluster``
(``MAX_CLUSTER``, the largest cluster the plan takes), ``span``
(``_MIN_SPAN_BYTES``, an image's span of a group at the least),
``oneblocks`` (``_REDUCE_BLOCKS_ONE``, the most blocks with one channel a
group) and ``second`` (``_SECOND_BELOW``: a grid of fewer blocks takes the
second level); and ``first=0``, a copy of ``bn_reduce_plan`` that grows
the clusters first (its groups of runs narrowed only until groups times
``MAX_CLUSTER`` make the grid, where the tree's narrows them until the
groups alone do). For each, the ``bn`` part of
``tools/torch_kernel_ab.py`` times ``bn_stats`` and ``bn_bwd_reduce`` at
its ``BN_SHAPES``, back to back and with L2 flushed, beside each shape's
plan; the library's calls are not timed. The result line starts with
``PLANS``. Imports nothing of JAX.
"""
import inspect
import json
import os
import sys


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    values = sys.argv[2:] or ["-"]
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    if not torch.cuda.is_available():
        print("torch_bn_plans: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import torch_kernel_ab as ab
    from mxnet_tpu_torch.ops.cuda import batch_norm as bn
    dev = torch.device("cuda:0")
    res = dict(root=root, card=cs.smi_line(), plans={})
    names = {"blocks": "_REDUCE_BLOCKS", "oneblocks": "_REDUCE_BLOCKS_ONE",
             "floor": "_MIN_REDUCE_BLOCKS", "cluster": "MAX_CLUSTER",
             "span": "_MIN_SPAN_BYTES", "second": "_SECOND_BELOW"}
    kept = {k: getattr(bn, n) for k, n in names.items()}
    own = bn.bn_reduce_plan
    narrow = "C // want //"
    source = inspect.getsource(own)
    assert narrow in source, "bn_reduce_plan no longer narrows as expected"
    for v in values:
        for k, n in names.items():
            setattr(bn, n, kept[k])
        bn.bn_reduce_plan = own
        for item in v.split(","):
            if item == "-":
                continue
            k, _, val = item.partition("=")
            if k == "first":
                if not int(val):     # the patched copy, in the module
                    exec(source.replace(
                        narrow, "C // _cdiv(want, MAX_CLUSTER) //"),
                        vars(bn))
            else:
                setattr(bn, names[k], type(kept[k])(int(val)))
        times = ab.bn_times(torch, cs, dev, bn, library=False)
        for outer, C, M, dtn in ab.BN_SHAPES:
            label = f"({outer}, {C}, {M}) {dtn}"
            plan = bn.bn_reduce_plan(outer, C, M, getattr(torch, dtn))
            times[label]["plan"] = {k: plan[k] for k in (
                "cg", "rows", "cluster", "splits", "per", "blocks")}
        res["plans"][v] = times
        print(f"plans {v}: " + json.dumps(times), flush=True)
    for k, n in names.items():
        setattr(bn, n, kept[k])
    bn.bn_reduce_plan = own
    print("PLANS " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
