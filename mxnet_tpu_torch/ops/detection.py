"""Detection ops: box IoU and NMS, and the SSD MultiBox family.

Counterpart of ``mxnet_tpu/ops/detection.py`` (``_contrib_box_iou``,
``_contrib_box_nms``, ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection``, ``_contrib_box_encode``, ``_contrib_box_decode``),
with every alias.  All are compositions of torch calls, as the reference's
were XLA, and none is differentiable.  Shapes are the reference's: a
suppressed or invalid row keeps its place and is -1 throughout.

What differs from the reference, and why:

* ``box_nms`` does not build the (B, N, N) IoU matrix over all N rows
  (9.8 GB at SSD-300's 8,732 anchors and batch 32).  Rows past ``topk`` in
  score order and invalid rows suppress nothing and are never kept, so the
  valid rows form a prefix of the sorted order and only that prefix is
  compared.  Greedy suppression is the unique solution of ``keep[j] =
  valid[j] and no kept i < j overlaps j``; it is reached by applying that
  rule to the whole prefix at once until nothing changes (each pass
  settles at least one more row, so at most as many passes as rows, and
  in practice a few), instead of a loop over every row.
* ``MultiBoxTarget`` lets only valid ground truths (class >= 0) claim the
  anchor they overlap best.  The reference scatters every label row,
  padding included; a padding row's best anchor is anchor 0 (IoU -1
  everywhere), so a padding row after a valid row that claimed anchor 0
  undoes that claim.  Among valid rows that share an anchor the later row
  wins, as in the reference; the rule is a reduction over rows, never a
  scatter with repeated indices (whose winner CUDA leaves open).
* The hard-negative ranking reads the background probability from a
  float64 softmax rounded to float32, so that the card and the CPU rank
  the same values; the sorts are stable, as ``jnp.argsort`` is.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["pairwise_iou"]


def _to_corner(x):
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def pairwise_iou(a, b, fmt="corner"):
    """IoU of (..., Na, 4) against (..., Nb, 4) boxes: (..., Na, Nb); 0
    where the union is empty."""
    if fmt == "center":
        a, b = _to_corner(a), _to_corner(b)
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    iw = (torch.minimum(ax2[..., :, None], bx2[..., None, :])
          - torch.maximum(ax1[..., :, None], bx1[..., None, :])).clamp_min(0)
    ih = (torch.minimum(ay2[..., :, None], by2[..., None, :])
          - torch.maximum(ay1[..., :, None], by1[..., None, :])).clamp_min(0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp_min(0) * (ay2 - ay1).clamp_min(0)
    area_b = (bx2 - bx1).clamp_min(0) * (by2 - by1).clamp_min(0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


@register("_contrib_box_iou", differentiable=False, aliases=["box_iou"])
def _box_iou(lhs, rhs, format="corner"):
    return pairwise_iou(lhs, rhs, fmt=format)


def _greedy_keep(suppress, valid):
    """Greedy NMS over rows in score order: row j is kept when it is valid
    and no kept earlier row i has ``suppress[..., i, j]``.  ``suppress``
    must hold only i < j pairs."""
    keep = valid
    while True:
        hit = (suppress & keep[..., :, None]).any(dim=-2)
        new = valid & ~hit
        if torch.equal(new, keep):
            return keep
        keep = new


@register("_contrib_box_nms", differentiable=False, aliases=["box_nms"])
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """data: (..., N, K) rows; a row is valid when its score exceeds
    ``valid_thresh`` (and its id is not ``background_id``), at most
    ``topk`` valid rows by score are considered, and a row is dropped when
    a kept row of higher score (of its class, unless ``force_suppress``)
    overlaps it by more than ``overlap_thresh``.  Dropped and invalid rows
    become -1; the output has data's shape and row order."""
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    n = flat.shape[1]
    scores = flat[..., score_index]
    ids = flat[..., id_index] if id_index >= 0 else None
    valid = scores > valid_thresh
    if background_id >= 0 and ids is not None:
        valid &= ids != background_id
    inf = torch.full_like(scores, float("inf"))
    order = torch.sort(torch.where(valid, -scores, inf), dim=-1,
                       stable=True)[1]
    # valid rows sort first, so the rows that can be kept are a prefix
    count = valid.sum(dim=-1)
    if topk > 0:
        count = count.clamp_max(int(topk))
    v = int(count.max()) if count.numel() else 0
    keep_sorted = torch.zeros_like(valid)
    if v:
        head = order[:, :v]
        boxes = torch.gather(flat[..., coord_start:coord_start + 4], 1,
                             head[..., None].expand(-1, -1, 4))
        pos = torch.arange(v, device=data.device)
        valid_s = pos[None, :] < count[:, None]
        suppress = pairwise_iou(boxes, boxes, fmt=in_format) > overlap_thresh
        if ids is not None and not force_suppress:
            ids_s = torch.gather(ids, 1, head)
            suppress &= ids_s[:, :, None] == ids_s[:, None, :]
        suppress &= pos[:, None] < pos[None, :]
        keep_sorted[:, :v] = _greedy_keep(suppress, valid_s)
    keep = torch.zeros_like(valid).scatter(1, order, keep_sorted)
    out = torch.where(keep[..., None], flat, torch.full_like(flat, -1.0))
    return out.reshape(shape)


def _f32(v, device):
    return torch.tensor(float(v), dtype=torch.float32, device=device)


@register("MultiBoxPrior", differentiable=False,
          aliases=["_contrib_MultiBoxPrior", "multibox_prior"])
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """data: (B, C, H, W) feature map -> (1, H*W*A, 4) corner anchors,
    A = len(sizes) + len(ratios) - 1: every size at ratios[0], then
    sizes[0] at each later ratio.  Computed in float32 in the reference's
    order (each Python number rounded to float32 first, as JAX's weak
    typing does), so the anchors agree to the bit."""
    dev = data.device
    h, w = data.shape[-2], data.shape[-1]
    sizes = tuple(sizes) if isinstance(sizes, (tuple, list)) else (sizes,)
    ratios = tuple(ratios) if isinstance(ratios, (tuple, list)) \
        else (ratios,)
    step_y = steps[1] if steps[1] > 0 else 1.0 / h
    step_x = steps[0] if steps[0] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev)
          + _f32(offsets[1], dev)) * _f32(step_y, dev)
    cx = (torch.arange(w, dtype=torch.float32, device=dev)
          + _f32(offsets[0], dev)) * _f32(step_x, dev)
    pairs = [(s, ratios[0]) for s in sizes] + \
        [(sizes[0], r) for r in ratios[1:]]
    root = torch.sqrt(torch.tensor([float(r) for _, r in pairs],
                                   dtype=torch.float32, device=dev))
    size = torch.tensor([float(s) for s, _ in pairs], dtype=torch.float32,
                        device=dev)
    half_w = (size * root) / 2
    half_h = (size / root) / 2
    a = len(pairs)
    ctr_y = cy[:, None, None].expand(h, w, a)
    ctr_x = cx[None, :, None].expand(h, w, a)
    anchors = torch.stack([ctr_x - half_w, ctr_y - half_h,
                           ctr_x + half_w, ctr_y + half_h], dim=-1)
    anchors = anchors.reshape(1, h * w * a, 4)
    return anchors.clamp(0.0, 1.0) if clip else anchors


@register("MultiBoxTarget", differentiable=False, num_outputs=3,
          aliases=["_contrib_MultiBoxTarget", "multibox_target"])
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """anchor: (1, N, 4) corners; label: (B, M, 5) rows [cls, x1, y1, x2,
    y2], padded with cls = -1; cls_pred: (B, classes + 1, N).  Returns
    (loc_target (B, N*4), loc_mask (B, N*4), cls_target (B, N)):
    cls_target is 0 for background, k + 1 for class k, ``ignore_label``
    for a negative that hard-negative mining drops.  An anchor is positive
    when its best IoU with a valid ground truth reaches
    ``overlap_threshold``, or when a valid ground truth overlaps it best
    of all anchors (the later row winning a shared anchor); padding rows
    claim nothing (see the module's notes)."""
    anchors = anchor.reshape(-1, 4)
    n = anchors.shape[0]
    b, m = label.shape[0], label.shape[1]
    dev = label.device
    gt_cls = label[..., 0]
    gt_box = label[..., 1:5]
    gt_valid = gt_cls >= 0

    iou = pairwise_iou(anchors.expand(b, n, 4), gt_box)          # (B,N,M)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.max(dim=-1)
    matched = best_iou >= overlap_threshold

    # each valid ground truth claims the anchor it overlaps best; of the
    # rows claiming one anchor the largest row index wins
    best_anchor = iou.argmax(dim=1)                                # (B, M)
    claims = (best_anchor[:, :, None] == torch.arange(n, device=dev)) \
        & gt_valid[:, :, None]                                     # (B,M,N)
    rows = torch.arange(m, device=dev)[None, :, None]
    forced_gt = torch.where(claims, rows, torch.full_like(rows, -1)) \
        .amax(dim=1)                                               # (B, N)
    forced = forced_gt >= 0
    match_gt = torch.where(forced, forced_gt, best_gt)
    is_pos = matched | forced

    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    g = torch.gather(gt_box, 1, match_gt[..., None].expand(b, n, 4))
    gw = g[..., 2] - g[..., 0]
    gh = g[..., 3] - g[..., 1]
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    eps = 1e-8
    aw_, ah_ = aw.clamp_min(eps), ah.clamp_min(eps)
    loc_t = torch.stack([
        (gcx - acx) / aw_ / variances[0],
        (gcy - acy) / ah_ / variances[1],
        torch.log((gw / aw_).clamp_min(eps)) / variances[2],
        torch.log((gh / ah_).clamp_min(eps)) / variances[3]], dim=-1)
    pos = is_pos[..., None]
    loc_target = torch.where(pos, loc_t, torch.zeros_like(loc_t)) \
        .reshape(b, n * 4)
    loc_mask = pos.expand(b, n, 4).to(loc_t.dtype).reshape(b, n * 4)

    matched_cls = torch.gather(gt_cls, 1, match_gt)
    cls_target = torch.where(is_pos, matched_cls + 1.0,
                             torch.zeros_like(matched_cls))
    if negative_mining_ratio > 0:
        # the hardest negatives have the smallest background probability;
        # positives rank last
        bg_prob = torch.softmax(cls_pred.double(), dim=1)[:, 0, :] \
            .to(torch.float32)
        neg_score = torch.where(is_pos, torch.full_like(bg_prob,
                                                        float("inf")),
                                bg_prob)
        order = torch.sort(neg_score, dim=-1, stable=True)[1]
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device=dev).expand(b, n).contiguous())
        n_pos = is_pos.sum(dim=-1, keepdim=True)
        n_neg = torch.clamp_min(negative_mining_ratio * n_pos,
                                minimum_negative_samples)
        keep_neg = rank < n_neg
        cls_target = torch.where(is_pos | keep_neg, cls_target,
                                 torch.full_like(cls_target, ignore_label))
    return loc_target, loc_mask, cls_target


def _decode_center(loc, anchors, variances):
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw
    h = torch.exp(loc[..., 3] * variances[3]) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


@register("MultiBoxDetection", differentiable=False,
          aliases=["_contrib_MultiBoxDetection", "multibox_detection"])
def multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """cls_prob: (B, classes + 1, N); loc_pred: (B, N*4); anchor: (1, N,
    4).  Each anchor's box is decoded and given its best non-background
    class and score; rows scoring at most ``threshold`` are dropped, the
    rest go through :func:`box_nms` by class.  Returns (B, N, 6) rows
    [class, score, x1, y1, x2, y2], dropped rows -1."""
    b = cls_prob.shape[0]
    n = anchor.shape[1]
    boxes = _decode_center(loc_pred.reshape(b, n, 4), anchor.reshape(n, 4),
                           variances)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    prob = cls_prob.transpose(1, 2)                         # (B, N, C+1)
    if background_id == 0:
        fg = prob[..., 1:]
    else:
        keep = [c for c in range(prob.shape[-1]) if c != background_id]
        fg = prob[..., keep]
    score, cls_id = fg.max(dim=-1)
    keep = score > threshold
    neg = torch.full_like(score, -1.0)
    cls_id = cls_id.to(boxes.dtype)
    rows = torch.cat([torch.where(keep, cls_id, neg)[..., None],
                      torch.where(keep, score, neg)[..., None],
                      torch.where(keep[..., None], boxes,
                                  torch.full_like(boxes, -1.0))], dim=-1)
    return box_nms(rows, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


@register("_contrib_box_encode", aliases=["box_encode"], num_outputs=2,
          differentiable=False)
def _box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
                stds=(0.1, 0.1, 0.2, 0.2)):
    """Corner anchors and their matched corner references -> center-form
    regression targets and masks (rows whose sample is > 0.5)."""
    idx = matches.to(torch.int64)[..., None].expand(
        tuple(matches.shape) + (4,))
    g = torch.gather(refs, 1, idx)
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    gw = g[..., 2] - g[..., 0]
    gh = g[..., 3] - g[..., 1]
    gx = g[..., 0] + 0.5 * gw
    gy = g[..., 1] + 0.5 * gh
    mean = [float(torch.tensor(v, dtype=torch.float32)) for v in means]
    std = [float(torch.tensor(v, dtype=torch.float32)) for v in stds]
    tiny = 1e-12
    t = torch.stack([
        ((gx - ax) / aw.clamp_min(tiny) - mean[0]) / std[0],
        ((gy - ay) / ah.clamp_min(tiny) - mean[1]) / std[1],
        (torch.log(gw.clamp_min(tiny) / aw.clamp_min(tiny)) - mean[2])
        / std[2],
        (torch.log(gh.clamp_min(tiny) / ah.clamp_min(tiny)) - mean[3])
        / std[3]], dim=-1)
    valid = (samples > 0.5)[..., None]
    targets = torch.where(valid, t, torch.zeros_like(t))
    masks = valid.expand_as(t).to(t.dtype)
    return targets, masks


@register("_contrib_box_decode", aliases=["box_decode"],
          differentiable=False)
def _box_decode(data, anchors, std0=1.0, std1=1.0, std2=1.0, std3=1.0,
                clip=-1.0, format="corner"):
    """Regression deltas and anchors (corner, or center with ``format``
    'center') -> corner boxes, clipped to [0, ``clip``] when clip > 0."""
    if format == "corner":
        aw = anchors[..., 2] - anchors[..., 0]
        ah = anchors[..., 3] - anchors[..., 1]
        ax = anchors[..., 0] + 0.5 * aw
        ay = anchors[..., 1] + 0.5 * ah
    else:
        ax, ay, aw, ah = anchors.unbind(-1)
    cx = data[..., 0] * std0 * aw + ax
    cy = data[..., 1] * std1 * ah + ay
    w = torch.exp(data[..., 2] * std2) * aw
    h = torch.exp(data[..., 3] * std3) * ah
    out = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                       cy + 0.5 * h], dim=-1)
    return out.clamp(0.0, clip) if clip > 0 else out
