"""Mixed-scale Sparse Voxel Transformer backbone (torch counterpart of
``mssvt_tpu/models/backbones_3d/mssvt.py``), inference and training.

``MsSVTBlock`` runs, per call: window partition, the mixed-scale gather
(K1 fill kernel), one FPS pass over the stacked win1/win2 buffers (K2),
the assembled attention (K3 forward, K5 backward; with ``ref_compat_keys``
off training assembles outside and runs K6/K7), 3-NN interpolation and
the inverse write-back, and the residual LayerNorm FFN: one K4 launch at
inference, the plain chain with its two DropPath draws in training (as the
JAX block, which keeps its FFN kernel for inference). ``MsSVTCompressBlock``
turns windows into the next stage's voxels with a max-pooled query on the
per-group einsum attention. Shapes are static; valid windows are a sorted
prefix of each block's capacity, and ``num_valid`` (a device scalar) lets
the kernels skip the tail without a host sync.

Training draws DropPath and dropout masks from the ``torch.Generator`` the
detector threads down (``generator=``), which must live on the model's
device, in the order the JAX blocks draw theirs: the attention's
``attn_drop_i``/``proj_drop_i`` per group, then DropPath, ``dropout1`` on
the FFN's hidden layer and on its output, DropPath. With dropout > 0 the
attention trains through the per-group einsum (the kernels carry no
dropout, and JAX leaves them there too).

At inference on the card (eval mode, no autograd, no generator) the
backbone's forward replays a CUDA graph of itself
(``runtime/graphs.ForwardGraph``): one launch in place of ~1 000 small
ones and their host time; the same kernels run inside it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.sparse import SparseVoxels
from ...kernels import ffn as ffn_kernel
from ...kernels.fill import PACK5_ZERO
from ...ops.sampling import (
    farthest_point_sample_planes_select,
    gather_along_batch,
    group_features,
    group_features_paired,
    three_interp_weights_planes,
    writeback_inverse_paired,
)
from ...ops.window import (
    build_query_tables,
    gather_window_voxels,
    unpack_planes,
    window_partition,
)
from ...runtime import graphs
from ..model_utils.attention import MixedScaleAttention
from ..model_utils.layers import Dense, DropPath, LayerNorm, PosProjection
from ..model_utils.layers import dropout as _dropout


def _parts(table_parts):
    return (None if table_parts is None else
            {k: np.asarray(v, np.int32) for k, v in dict(table_parts).items()})


class MsSVTBlock(nn.Module):
    """One mixed-scale window-attention stage (resolution-preserving)."""

    def __init__(self, in_channels, ff_channels, out_channels, num_heads,
                 window_size, max_windows, max_num_win1=None,
                 max_num_win2=None, cbs_mode="odd_even", cbs_pattern=1,
                 key_num_sample=32, use_feature_interpolation=True,
                 dropout=0.0, drop_path=0.0, dtype=torch.float32,
                 ref_compat_keys=True, table_parts=None):
        super().__init__()
        assert len(window_size) == 2, "MsSVTBlock needs two window scales"
        self.win1 = tuple(int(s) for s in window_size[0])
        self.win2 = tuple(int(s) for s in window_size[1])
        self.tables = build_query_tables(self.win1, self.win2, cbs_mode,
                                         parts=_parts(table_parts))
        self.cap1 = int(np.prod(self.win1)) if max_num_win1 is None else int(max_num_win1)
        self.cap2 = int(np.prod(self.win2)) if max_num_win2 is None else int(max_num_win2)
        self.max_windows = int(max_windows)
        self.cbs_pattern = int(cbs_pattern)
        self.key_num_sample = int(key_num_sample)
        self.use_feature_interpolation = bool(use_feature_interpolation)
        self.ref_compat_keys = bool(ref_compat_keys)
        self.compute_dtype = dtype
        self.in_channels, self.out_channels = in_channels, out_channels
        self.norm1 = LayerNorm(in_channels, dtype=dtype)
        self.norm2 = LayerNorm(in_channels, dtype=dtype)
        self.ms_attn = MixedScaleAttention(in_channels, num_heads, dropout,
                                           dtype=dtype)
        self.pos_proj = PosProjection(in_channels, deep=False, dtype=dtype)
        self.linear1 = Dense(in_channels, ff_channels, dtype=dtype)
        self.linear2 = Dense(ff_channels, in_channels, dtype=dtype)
        self.droppath = DropPath(drop_path)
        self.dropout = float(dropout)
        if out_channels != in_channels:
            self.out_linear = Dense(in_channels, out_channels, dtype=dtype)

    def dropout1(self, x, generator):
        return _dropout(x, self.dropout, self.training, generator)

    def forward(self, sp: SparseVoxels, generator=None) -> SparseVoxels:
        dt = self.compute_dtype
        bsz = sp.batch_size
        shortcut = sp.features
        x = self.norm1(shortcut)

        win_coords, win_valid, _, num_win, vrow = window_partition(
            sp.coords, sp.valid, sp.spatial_shape, self.win1,
            self.max_windows * bsz, bsz, return_ranks=True)
        nv = torch.clamp(num_win, max=self.max_windows * bsz)
        q_name = {0: "even", 1: "odd", 2: "win1"}[self.cbs_pattern]
        need = ("win1", "win2") if q_name == "win1" else (q_name, "win1", "win2")
        g = gather_window_voxels(
            win_coords, win_valid, sp.coords, sp.valid, sp.spatial_shape,
            self.win1, self.tables, max_num_win1=self.cap1,
            max_num_win2=self.cap2, batch_size=bsz, buffers=need,
            return_inverse=self.use_feature_interpolation, num_valid=nv,
            voxel_win_row=vrow)
        q = g[q_name]
        win1b, win2b = g["win1"], g["win2"]

        # one FPS pass over both scales: win1 padded to the win2 capacity
        n1, n2 = win1b["ind"].shape[1], win2b["ind"].shape[1]
        pad_ind = F.pad(win1b["ind"], (0, n2 - n1), value=-1)
        pad_p = F.pad(win1b["coordp"], (0, n2 - n1), value=PACK5_ZERO)
        both_ind = torch.cat([pad_ind, win2b["ind"]], dim=0)
        bx, by, bz = unpack_planes(torch.cat([pad_p, win2b["coordp"]], dim=0))
        nw = win1b["ind"].shape[0]
        fps, (sx, sy, sz, sind) = farthest_point_sample_planes_select(
            bx.float(), by.float(), bz.float(), (both_ind.float(),),
            self.key_num_sample, num_valid=nv, nw_half=nw)
        # repeated picks of slot 0 are masked (pick 0 itself is kept)
        col = torch.arange(fps.shape[1], device=fps.device)
        fps_mask = (fps == 0) & (col > 0)
        k_ind = sind.to(torch.int32)
        bstart = b_w = pad_row = None
        if self.ref_compat_keys:
            # empty-slot picks become real keys carrying the batch's first
            # voxel (the reference's (float + 0.1).int() maps -1 to row 0)
            pad_key = k_ind < 0
            b_w = win_coords[:, 0].clamp(0, bsz - 1).long()
            bstart = torch.stack([
                torch.argmax((sp.coords[:, 0] == b).to(torch.int32))
                for b in range(bsz)])
            # each window's pad row is its frame's first voxel row: taken
            # as a (NW, B) one-hot product with the B first rows (exact, one
            # nonzero term), whose backward is a (B, NW) product. Gathering
            # it per window (x[bstart[b_w]]) would send ~NW duplicates to B
            # rows, which the sorted index_put_ backward sums serially
            pad_row = F.one_hot(b_w, bsz).to(x.dtype) @ x[bstart]
            k_mask = fps_mask
            pad1, pad2 = pad_key[:nw], pad_key[nw:]
        else:
            k_mask = fps_mask | (k_ind < 0)
            pad1 = pad2 = None
        k_ind2 = k_ind[nw:]
        k_mask1, k_mask2 = k_mask[:nw], k_mask[nw:]
        fps1 = torch.clamp(fps[:nw], max=n1 - 1)

        inv = g.get("inv_win1") if self.use_feature_interpolation else None
        nq = q["ind"].shape[1]
        q_prefix_ok = q_name in ("odd", "win1") and nq <= n1
        if inv is not None:
            win1_fea = group_features_paired(
                x, win1b["ind"], inv["win_row"], inv["slot"], inv["valid"])
        else:
            win1_fea = group_features(x, win1b["ind"])
        if q_prefix_ok:
            q_ext = None
        elif (q_name == "even" and "start" in q
              and self.tables.num_odd + self.tables.num_even <= n1):
            # even cells are the win1-buffer run [odd_cnt, odd_cnt + nq)
            pos_q = torch.clamp(
                q["start"][:, None] + torch.arange(nq, device=fps.device),
                max=n1 - 1)
            q_ext = gather_along_batch(win1_fea, pos_q) \
                * (~q["mask"])[..., None].to(win1_fea.dtype)
        else:
            q_ext = group_features(x, q["ind"])
        # windows past nv hold FPS picks of 0; their attention output is
        # zero whatever their keys, so they pick nothing (else ~1M picks of
        # row 0 would meet in the gather's backward)
        live = torch.arange(nw, device=k_ind2.device) < nv
        k_ind2 = torch.where(live[:, None], k_ind2, -1)
        k_fea2 = group_features(x, k_ind2)  # pad picks (-1) give zero rows
        if self.ref_compat_keys:  # ... and carry the pad row instead
            k_fea2 = torch.where(pad2[..., None], pad_row[:, None, :], k_fea2)

        # metric centre of a buffer slot = window-centre voxel + offset
        vsx, vsy, vsz = sp.voxel_size
        minx, miny, minz = sp.point_cloud_range[:3]
        wx, wy, wz = self.win1
        ctr_x = (win_coords[:, 3] * wx + wx // 2)[:, None]
        ctr_y = (win_coords[:, 2] * wy + wy // 2)[:, None]
        ctr_z = (win_coords[:, 1] * wz + wz // 2)[:, None]

        def slot_metric_planes(p, empty):
            ox, oy, oz = unpack_planes(p)
            keep = (~empty).float()
            return ((((ctr_x + ox).float() + 0.5) * vsx + minx) * keep,
                    (((ctr_y + oy).float() + 0.5) * vsy + miny) * keep,
                    (((ctr_z + oz).float() + 0.5) * vsz + minz) * keep)

        def slot_metric_sel(ox, oy, oz, empty):
            keep = (~empty).float()
            return (((ctr_x + ox + 0.5) * vsx + minx) * keep,
                    ((ctr_y + oy + 0.5) * vsy + miny) * keep,
                    ((ctr_z + oz + 0.5) * vsz + minz) * keep)

        q_m = slot_metric_planes(q["coordp"], q["mask"])
        win1_m = slot_metric_planes(win1b["coordp"], win1b["mask"])
        k_m1 = slot_metric_sel(sx[:nw], sy[:nw], sz[:nw], k_mask1)
        k_m2 = slot_metric_sel(sx[nw:], sy[nw:], sz[nw:], k_mask2)
        if self.ref_compat_keys:
            c0 = sp.coords[bstart]
            m0 = ((c0[:, 3].float() + 0.5) * vsx + minx,
                  (c0[:, 2].float() + 0.5) * vsy + miny,
                  (c0[:, 1].float() + 0.5) * vsz + minz)
            k_m1 = tuple(torch.where(pad1, m[b_w][:, None], km)
                         for m, km in zip(m0, k_m1))
            k_m2 = tuple(torch.where(pad2, m[b_w][:, None], km)
                         for m, km in zip(m0, k_m2))
        wcx = (win_coords[:, 3].float() + 0.5) * (vsx * wx) + minx
        wcy = (win_coords[:, 2].float() + 0.5) * (vsy * wy) + miny
        wcz = (win_coords[:, 1].float() + 0.5) * (vsz * wz) + minz

        def rel_planes(m, empty):
            keep = (~empty).float()
            return ((m[0] - wcx[:, None]) * keep, (m[1] - wcy[:, None]) * keep,
                    (m[2] - wcz[:, None]) * keep)

        q_rel = rel_planes(q_m, q["mask"])
        k_rel = tuple(torch.cat([a, b], dim=1) for a, b in
                      zip(rel_planes(k_m1, k_mask1), rel_planes(k_m2, k_mask2)))
        assembled = dict(
            win1_fea=win1_fea, k2_fea=k_fea2, fps1=fps1, k_mask1=k_mask1,
            q_ext=q_ext, q_keep=(~q["mask"]).float(), q_rel=q_rel,
            k_rel=k_rel, pos_base=self.pos_proj.base_from_centers(wcx, wcy, wcz),
            pos_w=self.pos_proj.rel_kernel(), nq=nq, num_valid=nv)
        if self.ref_compat_keys:
            assembled["pad1"] = pad1
            assembled["pad_row"] = pad_row
        attn_fea = self.ms_attn(query_mask=q["mask"],
                                key_masks=torch.cat([k_mask1, k_mask2], dim=1),
                                assembled=assembled,
                                generator=generator)  # (NW, nq, C)

        if self.use_feature_interpolation:
            w3 = three_interp_weights_planes(*win1_m, *q_m, dtype=attn_fea.dtype)
            upd_ind, upd_fea = win1b["ind"], torch.bmm(w3, attn_fea)
        else:
            upd_ind, upd_fea = q["ind"], attn_fea
        if inv is not None:
            updated = writeback_inverse_paired(
                upd_fea, shortcut, upd_ind, inv["win_row"], inv["slot"],
                inv["valid"])
        else:
            v = sp.max_voxels
            flat = upd_ind.reshape(-1)
            safe = torch.where(flat >= 0, flat, v).long()
            base = torch.cat([shortcut, shortcut[:1]])
            base[safe] = upd_fea.reshape(-1, upd_fea.shape[-1]).to(shortcut.dtype)
            updated = base[:v]

        if self.training:
            # the plain chain; DropPath and dropout draw in JAX's order
            new = self.droppath(updated, generator) + shortcut
            act = self.linear2(self.dropout1(
                torch.relu(self.linear1(self.norm2(new))), generator))
            new = new + self.droppath(self.dropout1(act, generator),
                                      generator)
        else:
            # residual + LayerNorm + FFN: one K4 launch (droppath/dropout are
            # identities at inference)
            new = ffn_kernel.fused_residual_ffn(
                (updated + shortcut).to(dt).contiguous(), self.norm2.weight,
                self.norm2.bias, self.linear1.kernel(), self.linear1.bias,
                self.linear2.kernel(), self.linear2.bias, eps=self.norm2.eps,
                compute_dtype=dt)
        if self.out_channels != self.in_channels:
            new = self.out_linear(new)
        new = new * sp.valid[:, None].to(new.dtype)
        return sp.with_features(new)


class MsSVTCompressBlock(nn.Module):
    """Downsampling stage: windows become the new voxels."""

    def __init__(self, in_channels, ff_channels, out_channels, num_heads,
                 window_size, max_windows, max_num_win1=None, dropout=0.0,
                 dtype=torch.float32, table_parts=None):
        super().__init__()
        assert len(window_size) == 1, "CompressBlock is single-scale"
        self.win1 = tuple(int(s) for s in window_size[0])
        self.tables = build_query_tables(self.win1, parts=_parts(table_parts))
        self.cap1 = int(np.prod(self.win1)) if max_num_win1 is None else int(max_num_win1)
        self.max_windows = int(max_windows)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.norm1 = LayerNorm(in_channels, dtype=dtype)
        self.norm2 = LayerNorm(in_channels, dtype=dtype)
        self.ms_attn = MixedScaleAttention(in_channels, num_heads, dropout,
                                           dtype=dtype)
        self.pos_proj = PosProjection(in_channels, deep=True, dtype=dtype)
        self.linear1 = Dense(in_channels, ff_channels, dtype=dtype)
        self.linear2 = Dense(ff_channels, in_channels, dtype=dtype)
        self.dropout = float(dropout)
        if out_channels != in_channels:
            self.out_linear = Dense(in_channels, out_channels, dtype=dtype)

    def dropout1(self, x, generator):
        return _dropout(x, self.dropout, self.training, generator)

    def forward(self, sp: SparseVoxels, generator=None) -> SparseVoxels:
        bsz = sp.batch_size
        x = self.norm1(sp.features)
        win_coords, win_valid, win_grid, num_win, vrow = window_partition(
            sp.coords, sp.valid, sp.spatial_shape, self.win1,
            self.max_windows * bsz, bsz, return_ranks=True)
        nv = torch.clamp(num_win, max=self.max_windows * bsz)
        g = gather_window_voxels(
            win_coords, win_valid, sp.coords, sp.valid, sp.spatial_shape,
            self.win1, self.tables, max_num_win1=self.cap1, batch_size=bsz,
            return_inverse=self.training, num_valid=nv, voxel_win_row=vrow)
        k = g["win1"]
        inv = g.get("inv_win1")
        if inv is not None:
            # training: the key gather's backward is a row gather through
            # the voxel -> (window, slot) inverse map
            k_fea = group_features_paired(x, k["ind"], inv["win_row"],
                                          inv["slot"], inv["valid"])
        else:
            k_fea = group_features(x, k["ind"])  # (NW, ns, C)

        wx, wy, wz = self.win1
        vsx, vsy, vsz = sp.voxel_size
        minx, miny, minz = sp.point_cloud_range[:3]
        ox, oy, oz = unpack_planes(k["coordp"])
        keep = (~k["mask"]).float()
        ctr_x = (win_coords[:, 3] * wx + wx // 2)[:, None]
        ctr_y = (win_coords[:, 2] * wy + wy // 2)[:, None]
        ctr_z = (win_coords[:, 1] * wz + wz // 2)[:, None]
        mx = (((ctr_x + ox).float() + 0.5) * vsx + minx) * keep
        my = (((ctr_y + oy).float() + 0.5) * vsy + miny) * keep
        mz = (((ctr_z + oz).float() + 0.5) * vsz + minz) * keep
        qcx = (win_coords[:, 3].float() + 0.5) * (vsx * wx) + minx
        qcy = (win_coords[:, 2].float() + 0.5) * (vsy * wy) + miny
        qcz = (win_coords[:, 1].float() + 0.5) * (vsz * wz) + minz

        # query = max-pool over the window's keys (zero pads included); the
        # key position embedding is not masked (reference behaviour). amax
        # splits the gradient evenly over tied maxima, as jnp.max's VJP does
        # (ties at the zero pad rows are common); max().values would not
        q_fea = k_fea.amax(dim=1, keepdim=True)
        k_fea = k_fea + self.pos_proj.deep_from_planes(
            mx - qcx[:, None], my - qcy[:, None], mz - qcz[:, None],
            qcx, qcy, qcz)
        new = self.ms_attn(query=q_fea, keys=k_fea, key_masks=k["mask"],
                           generator=generator)[:, 0]
        act = self.linear2(self.dropout1(
            torch.relu(self.linear1(self.norm2(new))), generator))
        new = new + self.dropout1(act, generator)
        if self.out_channels != self.in_channels:
            new = self.out_linear(new)
        new = new * win_valid[:, None].to(new.dtype)
        # no index: the sparse-conv backbone that reads one builds it
        return SparseVoxels.create(
            new, win_coords, win_valid, bsz, win_grid,
            tuple(sp.voxel_size[i] * self.win1[i] for i in range(3)),
            sp.point_cloud_range, with_index=False)


class MixedScaleSparseTransformer(nn.Module):
    """The MsSVT backbone: ``input_proj`` then the configured blocks."""

    def __init__(self, params_cfg: Sequence[dict], in_features: int,
                 dropout=0.0, dtype=torch.float32):
        super().__init__()
        n = len(params_cfg)
        dpr = list(np.linspace(0.0, 0.3, max(n - 1, 1)))
        self.input_proj = Dense(in_features, int(params_cfg[0]["channels"][0]),
                                dtype=dtype)
        self.num_blocks = n
        for i, p in enumerate(params_cfg):
            in_c, ff_c, out_c = p["channels"]
            common = dict(
                in_channels=in_c, ff_channels=ff_c, out_channels=out_c,
                num_heads=tuple(p["num_heads"]),
                window_size=tuple(tuple(w) for w in p["window_size"]),
                max_windows=int(p.get("max_num_wins", 90000)),
                dropout=dropout, dtype=dtype)
            if p["name"] == "MixedScaleSparseTransformerBlock":
                block = MsSVTBlock(
                    **common, max_num_win1=p.get("max_num_win1"),
                    max_num_win2=p.get("max_num_win2"),
                    cbs_mode=p.get("cbs_mode", "odd_even"),
                    cbs_pattern=int(p.get("cbs_pattern", 1)),
                    key_num_sample=int(p.get("key_num_sample", 32)),
                    use_feature_interpolation=bool(
                        p.get("use_feature_interpolation", True)),
                    ref_compat_keys=bool(p.get("ref_compat_keys", True)),
                    drop_path=float(dpr[i]) if i < len(dpr) else 0.0)
            elif p["name"] == "MixedScaleSparseTransformerCompressBlock":
                block = MsSVTCompressBlock(**common,
                                           max_num_win1=p.get("max_num_win1"))
            else:
                raise NotImplementedError(p["name"])
            self.add_module(f"blocks_{i}", block)
        self.graph = graphs.ForwardGraph("backbone_graph", "MsSVT backbone")

    def blocks(self):
        return [getattr(self, f"blocks_{i}") for i in range(self.num_blocks)]

    def train(self, mode: bool = True):
        if mode:  # training never replays: free the graph's memory
            self.graph.clear()
        return super().train(mode)

    def stages(self, sp: SparseVoxels, generator=None, hooks=True):
        """The voxels after ``input_proj`` and after each block. With
        ``hooks`` False the blocks' ``forward`` runs without their hooks (a
        capture: its tensors hold nothing until a replay)."""
        feats = self.input_proj(sp.features) * sp.valid[:, None].to(
            self.input_proj.compute_dtype)
        out = [sp.with_features(feats)]
        for block in self.blocks():
            out.append((block if hooks else block.forward)(out[-1], generator))
        return out

    def forward(self, sp: SparseVoxels, generator=None) -> SparseVoxels:
        if not self._graphed(sp, generator):
            return self.stages(sp, generator)[-1]
        blocks = self.blocks()
        hooked = any(b._forward_hooks for b in blocks)
        stages, statics = self.graph.run(
            self, sp, ((None, lambda s, _: self.stages(s, hooks=False)),),
            self.stages, (lambda st: st) if hooked else (lambda st: st[-1:]))
        if statics is not None and hooked:
            graphs.run_forward_hooks(
                (b, (inp, None), out)
                for b, inp, out in zip(blocks, stages, stages[1:]))
        return stages[-1]

    def _graphed(self, sp, generator) -> bool:
        """Whether the call takes the CUDA graph
        (``runtime/graphs.graphable``); plain forward hooks on the blocks
        run after a replay."""
        return graphs.graphable(self, sp, generator, self.blocks())
