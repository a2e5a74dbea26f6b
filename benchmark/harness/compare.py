"""The numbers that decide ``correct`` for a detector's request: the
program's outputs, as the timed path produced them, against the plain
reference's on the same inputs and weights, stage by stage (each stage of
the reference takes the program's output of the stage before it; the
first takes the inputs):

- ``backbone_rel``: the 3-D backbone's output features on the valid rows
  (for MsSVT each block's), ``|p - r| / |r|`` (Frobenius), the worst;
  infinite where the rows or their coordinates differ (integer work,
  which must agree exactly);
- ``bev_rel``: the BEV backbone's output, the same ratio;
- ``head_rel``: each dense head map before decoding (heatmaps and box
  maps), the same ratio, the worst map;
- ``det_gap``: the program's kept detections against the reference's
  post-processing (decode, score threshold, rotated NMS) of the program's
  maps, in both directions: for each kept box of either side the nearest
  kept box of its class on the other (the centre in metres, the log of
  each size, the heading's angle wrapped to [0, pi] times the reference
  box's heading weight, the score; the largest of these), the worst box
  of the worst frame; infinite where a frame keeps a class on one side
  only. A heading decoded as ``atan2(sin, cos)`` of two regressed values
  is ill-conditioned where both are small, so the angle is weighed by
  ``min(1, |(cos, sin)|)`` of the candidate the box was decoded from: the
  error of the regressed vector, not of its angle;
- ``count_gap``: ``|n_p - n_r| / max(n_r, 1)`` of the detections kept in a
  frame, by the program and by the reference's post-processing of the
  program's maps, the worst frame (a box kept twice is no gap for
  ``det_gap``)."""

from __future__ import annotations

import math

import torch


def rel(p, r):
    p, r = p.double(), r.double()
    den = torch.linalg.vector_norm(r)
    num = torch.linalg.vector_norm(p - r)
    if float(den) == 0.0:
        return 0.0 if float(num) == 0.0 else math.inf
    return float(num / den)


def backbone_rel(prog, ref):
    """``prog``/``ref``: (features, coords, valid) of the backbone output."""
    pf, pc, pv = prog
    rf, rc, rv = ref
    if not torch.equal(pv.cpu(), rv.cpu()) or \
            not torch.equal(pc[pv].cpu(), rc[rv].cpu()):
        return math.inf
    return rel(pf[pv].float(), rf[rv].float())


def maps(preds, prefix=""):
    """Flat {path: tensor} of a head's output (dicts, lists, tensors)."""
    if isinstance(preds, torch.Tensor):
        return {prefix: preds}
    items = preds.items() if isinstance(preds, dict) else enumerate(preds)
    out = {}
    for k, v in items:
        out.update(maps(v, f"{prefix}/{k}"))
    return out


def as_f32(preds, device):
    """The head maps ``preds`` as float32 on ``device``, same structure."""
    from torch.utils._pytree import tree_map

    return tree_map(lambda t: t.to(device, torch.float32)
                    if isinstance(t, torch.Tensor) else t, preds)


def map_rels(prog, ref):
    """{map: |p - r| / |r|} of each dense head map."""
    p, r = maps(prog), maps(ref)
    if set(p) != set(r):
        return {"(maps differ)": math.inf}
    return {k: rel(p[k].float(), r[k].float().to(p[k].device))
            for k in sorted(r)}


def head_rel(prog, ref):
    return max(map_rels(prog, ref).values())


def box_distance(a, b, weight=None):
    """(P, 7) against (N, 7) boxes -> (P, N): the largest of the centre's
    offsets, the log-size ratios and the wrapped heading difference (times
    ``weight`` (N,) of the candidates, where given)."""
    d_ctr = (a[:, None, :3] - b[None, :, :3]).abs().amax(-1)
    la = torch.log(a[:, 3:6].clamp(min=1e-6))
    lb = torch.log(b[:, 3:6].clamp(min=1e-6))
    d_size = (la[:, None] - lb[None]).abs().amax(-1)
    dh = torch.remainder(a[:, None, 6] - b[None, :, 6], 2 * math.pi)
    d_head = torch.minimum(dh, 2 * math.pi - dh)
    if weight is not None:
        d_head = d_head * weight[None]
    return torch.maximum(torch.maximum(d_ctr, d_size), d_head)


def _frame(dets, b, dev):
    """(boxes (N, 7), scores (N,), labels (N,)) kept in frame ``b``."""
    boxes, scores, labels, mask = dets
    m = mask[b].to(dev)
    return (boxes[b].to(dev)[m][:, :7].float(), scores[b].to(dev)[m].float(),
            labels[b].to(dev)[m])


def _heading_weights(boxes, labels, cands, chunk=64):
    """Each box's heading weight: that of the nearest candidate of its
    class (the one it was decoded from). ``cands``: (boxes (M, 7+), scores
    (M,), labels (M,), heading weights (M,)) of one frame."""
    cb, _, cl, cw = cands
    w = torch.ones(len(boxes), device=boxes.device)
    for lab in torch.unique(labels).tolist():
        pick = labels == lab
        sel = cl == lab
        rb, rw = cb[sel][:, :7].float(), cw[sel].float()
        pb = boxes[pick]
        w[pick] = torch.cat([rw[box_distance(pb[i:i + chunk], rb).argmin(1)]
                             for i in range(0, len(pb), chunk)])
    return w


def det_gap(dets, kept, cands):
    """``dets``: the program's (boxes (B, N, 7+), scores (B, N), labels (B,
    N), mask (B, N)); ``kept``: the reference's post-processing of the
    program's maps, in the same form; ``cands``: the reference's decoded
    candidates of every location and class (boxes (B, M, 7+), scores,
    labels, heading weights), for the heading weights of its kept boxes."""
    dev = cands[0].device
    worst = 0.0
    for b in range(dets[0].shape[0]):
        pb, ps, pl = _frame(dets, b, dev)
        rb, rs, rl = _frame(kept, b, dev)
        rw = _heading_weights(rb, rl, tuple(c[b] for c in cands))
        for lab in set(torch.unique(pl).tolist()) | set(
                torch.unique(rl).tolist()):
            p, r = pl == lab, rl == lab
            if not p.any() or not r.any():
                return math.inf
            d = torch.maximum(
                box_distance(pb[p], rb[r], rw[r]),
                (ps[p][:, None] - rs[r][None]).abs())
            worst = max(worst, float(d.amin(1).max()), float(d.amin(0).max()))
    return worst


def count_gap(prog_mask, ref_mask):
    n_p = prog_mask.sum(1).double().cpu()
    n_r = ref_mask.sum(1).double().cpu()
    return float(((n_p - n_r).abs() / n_r.clamp(min=1)).max())
