"""Bounding-box operators: IoU, NMS, matching, SSD's anchors, targets and
detection.

Counterpart of ``mxnet_tpu/ops/boxes.py``: ``box_iou``, ``box_nms``,
``bipartite_matching``, ``multibox_prior``, ``multibox_target`` and
``multibox_detection``, with the JAX signatures, static shapes (a
suppressed or invalid row is all -1) and the same formulas in the same
order (``_pairwise_iou``, ``_to_corner``, the encode and the decode). Plain
functions on tensors, each also ``register_op``'ed as an NDArray operator
(``mx.nd.<name>``, ``mx.nd.contrib.<name>``), as the JAX package registers
them.

``box_nms``'s greedy sweep, a ``lax.fori_loop`` over all N score-sorted
rows in the JAX package, runs on :mod:`.cuda.box_nms` (the hand-written
kernel on a CUDA tensor, the JAX sweep as a torch loop on a CPU tensor),
restricted to the first ``topk`` rows when ``topk > 0`` (no later row is
valid). The kernel gives only the boolean keep mask; the sort, the gather
and the -1 rows are torch ops, so the gradient passes through the gather
as the JAX package's does. The sorts are stable, as ``jnp.argsort`` is, so
tied scores keep the JAX order. ``multibox_target``'s scatter-max is
``scatter_reduce(..., "amax")``; ``bipartite_matching``'s min(M, N) steps
are a torch loop. A division by a constant divides by a 0-d f32 tensor:
PyTorch on the card would multiply by its reciprocal instead.
"""
from __future__ import annotations

import torch

from ..ndarray.register import register_tensor_op
from .cuda.box_nms import nms_keep, pairwise_iou

__all__ = ["box_iou", "box_nms", "bipartite_matching", "multibox_prior",
           "multibox_target", "multibox_detection"]


def _div(a, v: float):
    """``a / v`` for a Python number ``v``, as one IEEE division."""
    return a / torch.full((), v, dtype=a.dtype, device=a.device)


def _to_corner(b, fmt: str):
    """(..., 4) boxes to corner (x1, y1, x2, y2)."""
    if fmt == "corner":
        return b
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _take(x, idx):
    """``x`` (B, N, ...) gathered along axis 1 by ``idx`` (B, N)."""
    if x.ndim == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def box_iou(lhs, rhs, format: str = "corner"):  # noqa: A002
    """Pairwise IoU between (..., M, 4) and (..., N, 4) boxes."""
    return pairwise_iou(_to_corner(lhs.float(), format),
                        _to_corner(rhs.float(), format))


def box_nms(data, overlap_thresh: float = 0.5, valid_thresh: float = 0.0,
            topk: int = -1, coord_start: int = 2, score_index: int = 1,
            id_index: int = -1, background_id: int = -1,
            force_suppress: bool = False, in_format: str = "corner",
            out_format: str = "corner"):
    """Non-maximum suppression over (B, N, K) or (N, K) rows [..., score,
    ..., 4 coordinates, ...] (class id at ``id_index``): the rows
    score-sorted, the suppressed and invalid ones all -1."""
    squeeze = data.ndim == 2
    d = (data[None] if squeeze else data).float()
    B, N, _ = d.shape
    scores = d[:, :, score_index]
    boxes = _to_corner(d[:, :, coord_start:coord_start + 4], in_format)
    cls = d[:, :, id_index] if id_index >= 0 else torch.zeros_like(scores)
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid &= cls != background_id
    neg_inf = torch.full_like(scores, -float("inf"))
    order = torch.argsort(-torch.where(valid, scores, neg_inf), dim=1,
                          stable=True)
    valid_sorted = _take(valid, order)
    n = N
    if topk > 0:
        valid_sorted &= torch.arange(N, device=d.device)[None, :] < topk
        n = min(N, topk)
    keep = torch.zeros((B, N), dtype=torch.bool, device=d.device)
    if N:
        order_n = order[:, :n]
        keep = nms_keep(_take(boxes, order_n).detach(),
                        _take(cls, order_n).detach(), valid_sorted,
                        overlap_thresh, force_suppress)
    out = torch.where(keep[..., None], _take(d, order), -1.0)
    if out_format != in_format:
        coords = out[:, :, coord_start:coord_start + 4]
        if out_format == "center":
            x1, y1, x2, y2 = coords.unbind(-1)
            conv = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
                                y2 - y1], -1)
        else:
            conv = _to_corner(coords, in_format)
        conv = torch.where(keep[..., None], conv, -1.0)
        out = torch.cat([out[:, :, :coord_start], conv,
                         out[:, :, coord_start + 4:]], -1)
    return out[0] if squeeze else out


def bipartite_matching(data, threshold: float = 0.5, topk: int = -1,
                       is_ascend: bool = False):
    """Greedy bipartite matching over a (B, M, N) score matrix: take the
    best remaining pair min(M, N) (or ``topk``) times. Returns (row_match
    (B, M), col_match (B, N)), -1 where unmatched."""
    squeeze = data.ndim == 2
    d = (data[None] if squeeze else data).float()
    B, M, N = d.shape
    steps = min(M, N) if topk <= 0 else min(topk, M, N)
    rows = torch.full((B, M), -1.0, device=d.device)
    cols = torch.full((B, N), -1.0, device=d.device)
    mat = d.detach().clone()
    bi = torch.arange(B, device=d.device)
    mi = torch.arange(M, device=d.device)[None, :, None]
    ni = torch.arange(N, device=d.device)[None, None, :]
    worst = float("inf") if is_ascend else -float("inf")
    for _ in range(steps):
        flat = mat.reshape(B, M * N)
        idx = torch.argmin(flat if is_ascend else -flat, dim=1)
        ri, ci = idx // N, idx % N
        val = flat.gather(1, idx[:, None])[:, 0]
        ok = val <= threshold if is_ascend else val >= threshold
        rows[bi, ri] = torch.where(ok, ci.float(), rows[bi, ri])
        cols[bi, ci] = torch.where(ok, ri.float(), cols[bi, ci])
        chosen = ok[:, None, None] & ((mi == ri[:, None, None])
                                      | (ni == ci[:, None, None]))
        mat = torch.where(chosen, worst, mat)
    if squeeze:
        return rows[0], cols[0]
    return rows, cols


def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip: bool = False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors for an (B, C, H, W) feature map: (1, H*W*A, 4) corner
    boxes, A = len(sizes) + len(ratios) - 1 (every size at ratios[0], then
    sizes[0] at each further ratio)."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    sy = 1.0 / h if steps[0] <= 0 else steps[0]
    sx = 1.0 / w if steps[1] <= 0 else steps[1]
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) * sy
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) * sx
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    f32 = (lambda v: torch.tensor(float(v), dtype=torch.float32))
    szs = [f32(s) for s in sizes]
    roots = [torch.sqrt(f32(r)) for r in ratios]
    whs = [(s * roots[0], s / roots[0]) for s in szs]
    whs += [(szs[0] * r, szs[0] / r) for r in roots[1:]]
    anchors = [torch.stack([gx - aw / 2, gy - ah / 2, gx + aw / 2,
                            gy + ah / 2], -1) for aw, ah in whs]
    out = torch.stack(anchors, 2).reshape(1, -1, 4)
    return out.clamp(0.0, 1.0) if clip else out


def multibox_target(anchor, label, cls_pred,
                    overlap_threshold: float = 0.5,
                    ignore_label: float = -1.0,
                    negative_mining_ratio: float = -1.0,
                    negative_mining_thresh: float = 0.5,
                    minimum_negative_samples: int = 0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets: anchor (1, N, 4) corner, label (B, M, 5) rows
    [cls, x1, y1, x2, y2] (cls -1 pads), cls_pred (B, C, N) for hard
    negative mining. Returns (loc_target (B, N*4), loc_mask (B, N*4),
    cls_target (B, N)): gt class + 1 where matched, 0 for kept negatives,
    ``ignore_label`` for negatives mined away."""
    v0, v1, v2, v3 = [float(v) for v in variances]
    a = anchor[0].float()
    N = a.shape[0]
    lab = label.float()
    B, M, _ = lab.shape
    dev = a.device
    acx = (a[:, 0] + a[:, 2]) / 2
    acy = (a[:, 1] + a[:, 3]) / 2
    aw = (a[:, 2] - a[:, 0]).clamp_min(1e-12)
    ah = (a[:, 3] - a[:, 1]).clamp_min(1e-12)

    gt_valid = lab[:, :, 0] >= 0                                  # B,M
    iou = pairwise_iou(a[None], lab[:, :, 1:5])                   # B,N,M
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    # each anchor's best gt, and the best anchor of each valid gt forced to
    # match it; scatter-max, so a padding row (its argmax lands on anchor 0)
    # never clobbers a valid gt's forced match, and of two gts sharing a
    # best anchor the higher index wins, as in the JAX package
    best_gt = torch.argmax(iou, dim=2)
    best_iou = iou.amax(dim=2)
    best_anchor = torch.argmax(iou, dim=1)                        # B,M
    forced = torch.zeros((B, N), dtype=torch.int32, device=dev).scatter_reduce(
        1, best_anchor, gt_valid.to(torch.int32), "amax") > 0
    cand = torch.where(gt_valid, torch.arange(M, dtype=torch.int32,
                                              device=dev)[None, :], -1)
    forced_gt = torch.full((B, N), -1, dtype=torch.int32,
                           device=dev).scatter_reduce(1, best_anchor, cand,
                                                      "amax")
    matched = forced | (best_iou >= overlap_threshold)
    gt_idx = torch.where(forced, forced_gt.long(), best_gt)       # B,N

    g = _take(lab, gt_idx)                                        # B,N,5
    gcx = (g[..., 1] + g[..., 3]) / 2
    gcy = (g[..., 2] + g[..., 4]) / 2
    gw = (g[..., 3] - g[..., 1]).clamp_min(1e-12)
    gh = (g[..., 4] - g[..., 2]).clamp_min(1e-12)
    dx = _div((gcx - acx) / aw, v0)
    dy = _div((gcy - acy) / ah, v1)
    dw = _div(torch.log(gw / aw), v2)
    dh = _div(torch.log(gh / ah), v3)
    loc_t = torch.stack([dx, dy, dw, dh], -1)
    loc_t = torch.where(matched[..., None], loc_t, 0.0)
    loc_m = torch.where(matched[..., None], torch.ones_like(loc_t), 0.0)

    cls_t = torch.where(matched, g[..., 0] + 1.0, 0.0)
    if negative_mining_ratio > 0:
        # hard negatives: the unmatched anchors whose best class confidence
        # is highest; ratio * num_pos kept, the rest ignored
        max_conf = cls_pred.float().amax(dim=1)                   # B,N
        neg = ~matched
        num_pos = matched.sum(1)
        quota = (num_pos * negative_mining_ratio).to(torch.int32).clamp_min(
            minimum_negative_samples)
        conf = torch.where(neg & (best_iou < negative_mining_thresh),
                           max_conf, -float("inf"))
        rank = torch.argsort(torch.argsort(-conf, dim=1, stable=True), dim=1,
                             stable=True)
        keep_neg = neg & (rank < quota[:, None])
        cls_t = torch.where(matched, cls_t,
                            torch.where(keep_neg, 0.0, ignore_label))
    return loc_t.reshape(B, N * 4), loc_m.reshape(B, N * 4), cls_t


def multibox_detection(cls_prob, loc_pred, anchor, clip: bool = True,
                       threshold: float = 0.01, background_id: int = 0,
                       nms_threshold: float = 0.5,
                       force_suppress: bool = False,
                       variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk: int = -1):
    """SSD inference: decode loc_pred (B, N*4) against anchor (1, N, 4),
    take each anchor's best foreground class of cls_prob (B, C, N), then
    :func:`box_nms`. Returns (B, N, 6) rows [class_id, score, x1, y1, x2,
    y2], suppressed and background rows -1. ``background_id`` is 0 (class 0
    is background, ids shifted down by one) or negative (none)."""
    if background_id > 0:
        raise ValueError(
            "multibox_detection: background_id must be 0 (reference "
            "convention — class 0 is background) or negative (no "
            f"background class); got {background_id}. Nonzero background "
            "classes would shift the reported ids of higher classes.")
    v0, v1, v2, v3 = [float(v) for v in variances]
    B, C, N = cls_prob.shape
    a = anchor[0].float()
    acx = (a[:, 0] + a[:, 2]) / 2
    acy = (a[:, 1] + a[:, 3]) / 2
    aw = a[:, 2] - a[:, 0]
    ah = a[:, 3] - a[:, 1]
    p = loc_pred.reshape(B, N, 4).float()
    cx = p[..., 0] * v0 * aw + acx
    cy = p[..., 1] * v1 * ah + acy
    w = torch.exp(p[..., 2] * v2) * aw
    h = torch.exp(p[..., 3] * v3) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = cls_prob[:, 1:] if background_id == 0 else cls_prob
    fg = fg.float()
    cid = torch.argmax(fg, dim=1).float()
    score = fg.amax(dim=1)
    valid = score > threshold
    rows = torch.cat([torch.where(valid, cid, -1.0)[..., None],
                      torch.where(valid, score, -1.0)[..., None], boxes], -1)
    return box_nms(rows, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


for _name in __all__:
    register_tensor_op(_name, globals()[_name])
