"""The work of one call of each kernel, and a context that tallies a run's
FLOPs and the bytes it moves.

One copy of the per-call formulas serves ``chip_smoke.py`` (each kernel
row's ``bound_ms``), ``tools/bench_attn_kernel_torch.py`` (K3's bound) and
the counting context below (``bench_torch.py``'s ``mfu``). Each formula
takes its wrapper's own arguments and returns a :class:`Work`.

FLOPs are counted as ``torch.utils.flop_counter.FlopCounterMode`` counts an
aten product: 2 per multiply-add of a matrix product or a convolution, and
nothing for elementwise work. K1 (fill) and the FPS kernels therefore count
no FLOPs; their bounds divide their elementwise operations by the f32 rate.
A kernel's FLOPs are the products of the function it computes: the
block-diagonal projections and per-head products of the live windows
(``num_valid``; for K7 the windows whose cotangent has a nonzero element),
not the dense (D, D) products over every window that the plain versions
compute.

Bounds: the bytes that a call must move (each input read once, each output
written once; rows past ``num_valid`` are not read) over the card's memory
rate, against its operations over the peak rate of their type, whichever
is larger (H100 SXM, NVIDIA's data sheet: 3.35 TB/s, 989 TFLOP/s dense
bf16, 67 TFLOP/s f32 outside the tensor cores).

Counting: inside ``with counting() as tally`` a ``FlopCounterMode`` counts
the aten products of whatever runs (the BEV convolutions, the head, the
3-NN interpolation's product), and every call of a wrapper decorated with
:func:`counted` adds its formula's FLOPs under its kernel's name. The aten
products counted while a wrapper ran (its plain version, for CPU tensors)
are taken back out, so a run counts the same work whether the kernels or
their plain versions ran. A formula that reads ``num_valid`` or a
cotangent's live windows syncs with the card, so count in a run of its own,
never in a timed one.

Bytes follow ``tools/hlo_bytes.py``'s rule, which charges each top-level
HLO instruction its result plus its distinct operands: a dispatch mode
entered with the FLOP counter charges each aten op the bytes of its tensor
results plus those of its distinct tensor operands (the same tensor passed
twice counts once; a broadcast operand, stride 0, its own elements once).
On top of that rule, for an eager program:

- views cost nothing, as ``bitcast`` and ``get-tuple-element`` do there:
  an op whose schema returns aliases and writes nothing (``view``,
  ``expand``, ``permute``, ``slice``, ``select``, ``detach``, ...), an
  in-place view (``squeeze_``, ``resize_``), and an op whose every result
  shares a storage with an operand though its schema declares no alias
  (``_unsafe_view``, which ``reshape`` and ``matmul`` use after a copy or
  a product); ``empty*`` costs nothing, a fill (``zeros``, ``full``,
  ``fill_``) its output;
- only tensors on the counting device count: a host-to-device copy is
  charged its device-side write alone;
- gathers (``index``, ``index_select``, ``gather``, ``embedding``) touch
  what these inputs need: the index read, the picked elements read and
  written (``index bytes + 2 x output bytes``), not the whole source;
- in-place scatters (``index_put_``, ``scatter_``, ``scatter_add_``,
  ``scatter_reduce_``, ``index_add_``, ``index_copy_``, ``index_fill_``)
  read their indices and values and write as many elements as the values
  fill; the accumulating ones also read those elements. An out-of-place
  scatter copies its whole destination and is charged as one;
- other in-place and ``out=`` ops read their operands and write their
  destination once; the destination is also read unless the op overwrites
  it (``copy_``, ``fill_``, ``zero_``, an ``out=`` argument).

Inside a :func:`counted` wrapper no aten op is charged: the formula's
``nbytes`` replaces whatever ran there, so any aten op a wrapper runs
around its launch (an allocation, a cast, a table upload) is part of the
kernel's charge, and a ctypes launch, which the dispatcher never sees, is
charged once. Every charge goes under a mechanism key: the innermost
active module's path (``torch.utils.module_tracker.ModuleTracker``, in the
forward), then the function scopes a caller opens with :func:`scoped`; a
charge made inside the backward takes the key of the forward code that
made its autograd node, marked ``[bwd] ``; a kernel's charge ends in
`` [name]``. Ops of the backward are counted on the autograd engine's
device thread too (the dispatch mode is part of the thread-local state the
engine carries there).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

MEM_BPS = 3.35e12     # H100 SXM HBM3 bytes/s
BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
F32_FLOPS = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores


class Work(NamedTuple):
    flops: int    # the products' FLOPs, as FlopCounterMode counts them
    ops: int      # the operations the bound divides by ``peak``
    nbytes: int   # each input read once, each output written once
    peak: float   # FLOP/s of the type of ``ops``

    def bound(self):
        """(bound_ms, "bytes" or "operations")."""
        t_by, t_op = self.nbytes / MEM_BPS, self.ops / self.peak
        return max(t_by, t_op) * 1e3, "bytes" if t_by >= t_op else "operations"


def _count(num_valid, default):
    return default if num_valid is None else int(num_valid)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def fill(box, offs_packed, cap, order=None, own_slab=None, elig=None,
         num_valid=None):
    """K1: the live rows' table entries read; both (NW, cap) outputs, the
    own slab's ranks and the counts written; 4 int32 operations an entry
    (load, compare, rank, store)."""
    nw, k = box.shape
    nv = _count(num_valid, nw)
    cv = own_slab[1] if own_slab else 0
    ops = nv * k * 4
    return Work(0, ops, nv * k * 4 + nw * (2 * int(cap) + cv + 8) * 4,
                F32_FLOPS)


def fps_select(x, y, z, aux, npoint, num_valid=None, nw_half=0):
    """K2: the live rows' planes read, picks and selections written; 10 f32
    operations a point and iteration (3 sub, 3 mul, 2 add, min, compare)."""
    rows, n = x.shape
    nv = _count(num_valid, rows // 2 if nw_half else rows)
    live = 2 * nv if nw_half else nv
    planes = 3 + len(aux)
    return Work(0, live * (npoint - 1) * n * 10,
                live * n * 4 * planes + rows * npoint * 4 * (1 + planes),
                F32_FLOPS)


def fps_picks(x, y, z, npoint):
    """K2b and K2c: the three planes read, the picks written, 10 f32
    operations a point and iteration."""
    b, n = x.shape
    return Work(0, b * (npoint - 1) * n * 10, 3 * b * n * 4 + b * npoint * 4,
                F32_FLOPS)


def fps_masked(x, y, z, valid, npoint):
    """The masked FPS: the frames' planes and the rows' valid flags read,
    the picks written, 10 f32 operations a valid point and iteration
    (counted on the data)."""
    f, n = x.shape
    rows = valid.shape[0]
    return Work(0, int(valid.sum()) * (npoint - 1) * 10,
                3 * f * n * 4 + rows * n + rows * npoint * 4, F32_FLOPS)


def _asm_layout(win1_fea, k2_fea, fps1, q_ext, num_heads, q_prefix, nq):
    nw, n1cap, d = win1_fea.shape
    nk1, nk2 = fps1.shape[1], k2_fea.shape[1]
    nq = int(nq) if q_prefix else q_ext.shape[1]
    ph = d // sum(num_heads)
    mac_proj = sum((ph * h) ** 2 for h in num_heads)  # a token, one matrix
    attn = sum(num_heads) * nq * ((nk1 + nk2) // len(num_heads)) * ph
    return nw, n1cap, d, nk1, nk2, nq, mac_proj, attn


def attention(win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel, q_rel,
              pos_base, pos_w, proj, key_bias, num_heads, scale, q_prefix,
              nq=0, pad_row=None, num_valid=None, compute_dtype=None):
    """K3 at bf16: the live windows' inputs read, every window's output
    written; its q/k/v and output projections and per-head products."""
    nw, n1cap, d, nk1, nk2, nq, mac_proj, attn = _asm_layout(
        win1_fea, k2_fea, fps1, q_ext, num_heads, q_prefix, nq)
    nkt = nk1 + nk2
    nv = _count(num_valid, nw)
    macs = (nq + 2 * nkt) * mac_proj + nq * mac_proj + 2 * attn
    per_win = (n1cap * d * 2 + nk2 * d * 2 + nk1 * 5 + nq * 4
               + (0 if q_prefix else nq * d * 2)
               + 4 * 3 * (nkt + nq) + d * 2 + nkt * 4
               + (d * 2 if pad_row is not None else 0))
    flops = 2 * macs * nv
    return Work(flops, flops, nv * per_win + nw * nq * d * 2 + 4 * d * d * 2,
                BF16_FLOPS)


def attention_bwd(win1_fea, k2_fea, fps1, k_mask1, q_ext, q_keep, k_rel,
                  q_rel, pos_base, pos_w, proj, key_bias, g, num_heads, scale,
                  q_prefix, nq=0, pad_row=None, num_valid=None,
                  compute_dtype=None):
    """K5 at bf16: the live windows' inputs read once, every output written
    once; the forward recompute, the backward's products and the full
    (D, D) weight products of the live windows."""
    nw, n1cap, d, nk1, nk2, nq, mac_proj, attn = _asm_layout(
        win1_fea, k2_fea, fps1, q_ext, num_heads, q_prefix, nq)
    nkt = nk1 + nk2
    nv = _count(num_valid, nw)
    macs = ((nq + 2 * nkt) * mac_proj + 2 * attn       # forward recompute
            + nq * mac_proj + 4 * attn                 # dO, dA, dV, dQ, dK
            + (nq + 2 * nkt) * mac_proj                # dQ3, dK3
            + (2 * nq + 2 * nkt) * d * d)              # dW (full D x D)
    per_win = (n1cap * d * 2 + nk2 * d * 2 + nk1 * 5 + nq * 4
               + (0 if q_prefix else nq * d * 2)
               + 4 * 3 * (nkt + nq) + d * 2 + nkt * 4 + d * 2 + nq * d * 2)
    outs = nw * (n1cap * d * 2 + nk2 * d * 2 + 2 * d * 2
                 + (0 if q_prefix else nq * d * 2))
    flops = 2 * macs * nv
    return Work(flops, flops,
                nv * per_win + 4 * d * d * 2 + outs + (4 * d * d + 7 * d) * 4,
                BF16_FLOPS)


def _qk_layout(query, keys, num_heads):
    nw, nq, d = query.shape
    nkt = keys.shape[1]
    ph = d // sum(num_heads)
    mac_proj = sum((ph * h) ** 2 for h in num_heads)  # a token, one matrix
    attn = sum(num_heads) * nq * (nkt // len(num_heads)) * ph
    es = query.element_size()
    weights = (4 * d * d + 4 * d) * es
    tokens = nw * (nq + nkt) * d * es + nw * nkt * 4
    return nw, nq, d, nkt, mac_proj, attn, es, weights, tokens


def attention_qk(query, keys, proj, key_bias, num_heads, scale,
                 compute_dtype=None):
    """K6: every window's tokens read once, the output written once; the
    block-diagonal products of every window."""
    nw, nq, d, nkt, mac_proj, attn, es, weights, tokens = _qk_layout(
        query, keys, num_heads)
    flops = 2 * ((nq + 2 * nkt) * mac_proj + nq * mac_proj + 2 * attn) * nw
    return Work(flops, flops, tokens + weights + nw * nq * d * es,
                BF16_FLOPS)


def live_windows(g):
    """The windows whose cotangent ``g`` has a nonzero element (a host
    sync on the card)."""
    return int((g.reshape(g.shape[0], -1) != 0).any(dim=1).sum())


def attention_qk_bwd(query, keys, proj, key_bias, g, num_heads, scale,
                     compute_dtype=None):
    """K7: g of every window, the tokens and products of the windows whose
    g has a nonzero element (the others' cotangents are zeros whatever
    their tokens): the forward recompute, the backward and the full (D, D)
    weight products; every output written once."""
    nw, nq, d, nkt, mac_proj, attn, es, weights, tokens = _qk_layout(
        query, keys, num_heads)
    live = live_windows(g)
    macs = ((nq + 2 * nkt) * mac_proj + 2 * attn       # forward recompute
            + nq * mac_proj + 4 * attn                 # dO, dA, dV, dQ, dK
            + (nq + 2 * nkt) * mac_proj                # dq, dk
            + (2 * nq + 2 * nkt) * d * d)              # dW (full D x D)
    nbytes = (tokens * live // nw + weights + nw * nq * d * es     # + g
              + nw * (nq + nkt) * d * es + (4 * d * d + 4 * d) * 4)
    flops = 2 * macs * live
    return Work(flops, flops, nbytes, BF16_FLOPS)


def ffn(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6, compute_dtype=None):
    """K4 at bf16: x read and the output written, both weights read once;
    its two products."""
    v, c = x.shape
    f = w1.shape[1]
    flops = 4 * v * c * f
    return Work(flops, flops, 2 * _nbytes(x) + 2 * c * f * 2, BF16_FLOPS)


def nms_greedy(over, cand_valid, order, post_max):
    """The greedy NMS scan: the (B, K, K) matrix, the validity and the
    order read, the selections and counts written; its K serial steps a
    sample as the operations (a step is a few integer operations on the
    critical path, so the bound is the bytes')."""
    b, k = cand_valid.shape
    return Work(0, b * k, _nbytes(over, cand_valid, order)
                + b * (int(post_max) + 1) * 4, F32_FLOPS)


def _upper_word_bytes(b, k):
    """Bytes of the packed rows' words at and right of each row's
    diagonal word, the words the mask writes and the scan reads."""
    words = (k + 63) // 64
    return b * 8 * sum(min(64, k - 64 * t) * (words - t)
                       for t in range(words))


def nms_greedy_packed(words, cand_valid, order, post_max):
    """The scan on packed rows: the rows' upper words, the validity and
    the order read, the selections and counts written; K serial steps a
    sample, as :func:`nms_greedy`."""
    b, k = cand_valid.shape
    return Work(0, b * k, _upper_word_bytes(b, k)
                + _nbytes(cand_valid, order) + b * (int(post_max) + 1) * 4,
                F32_FLOPS)


# f32 arithmetic (adds, subtractions, products, divisions; compares and
# selects not counted) of csrc/nms_iou.cu: a pair's early-out test (two
# differences, two squares, two sums, the reach squared) and a pair past
# it: the A pass 4 x (4 x 10 + 11) + 3, the B pass with its anti-parallel
# test 4 x (4 x 13 + 11) + 3, and the IoU's 5
NMS_IOU_TEST_OPS = 7
NMS_IOU_PAIR_OPS = 467


def nms_iou_mask(boxes, near: int):
    """The rotated-IoU mask: the boxes read, each row's words at and right
    of its diagonal word written; every upper-triangle pair's early-out
    test, and the full IoU of the ``near`` pairs past it (counted on the
    data, ``kernels/nms_iou.near_pairs``)."""
    b, k = boxes.shape[:2]
    ops = (b * k * (k - 1) // 2 * NMS_IOU_TEST_OPS
           + int(near) * NMS_IOU_PAIR_OPS)
    return Work(0, ops, _nbytes(boxes) + _upper_word_bytes(b, k), F32_FLOPS)


# f32 operations of a pair in csrc/ball_query.cu: 3 differences, 3 squares,
# 2 sums (the compare not counted)
BALL_QUERY_PAIR_OPS = 8


def ball_query(radius, nsample, xyz, new_xyz, xyz_valid=None):
    """The ball query: every query's full walk over its frame's support
    points as the operations (a walk that stops at ``nsample`` hits does
    less); the points, the queries and the valid flags read, the slots and
    the empty flags written."""
    b, n = xyz.shape[:2]
    m = new_xyz.shape[1]
    read = (b * n + b * m) * 3 * 4 + (0 if xyz_valid is None else b * n)
    written = b * m * int(nsample) * 4 + b * m
    return Work(0, b * m * n * BALL_QUERY_PAIR_OPS, read + written, F32_FLOPS)


_DTYPE_NAMES = {
    torch.bool: "pred", torch.uint8: "u8", torch.int8: "s8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.float32: "f32",
    torch.float64: "f64"}
GATHERS = {"index", "index_select", "gather", "embedding"}
SCATTERS = {"index_put_", "scatter_", "scatter_add_", "scatter_reduce_",
            "index_add_", "index_copy_", "index_fill_"}
OVERWRITES = {"copy_", "fill_", "zero_"}  # in-place, destination not read
BWD = "[bwd] "


def touched(t):
    """Bytes of a tensor's elements, each once (a stride-0 dim once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride:
            n *= size
    return n * t.element_size()


def describe(t):
    """``bf16[96000,48,128]`` (HLO's spelling)."""
    name = _DTYPE_NAMES.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{name}[{','.join(map(str, t.shape))}]"


def group_key(key, segments=3):
    """``key`` with its module path cut to its first ``segments`` parts, as
    ``hlo_bytes --group`` cuts a name stack; the backward mark and the
    kernel's name stay."""
    prefix = BWD if key.startswith(BWD) else ""
    path, sep, kernel = key[len(prefix):].partition(" [")
    return prefix + "/".join(path.split("/")[:segments]) + sep + kernel


class _OpInfo(NamedTuple):
    func: object     # the OpOverload
    name: str        # aten.mm.default
    kind: str        # "free", "gather", "scatter" or "general"
    written: tuple   # (argument name, read too?) of each written argument


def _op_info(func):
    schema = func._schema
    packet = func._overloadpacket.__name__
    rets = schema.returns
    if (rets and all(r.alias_info is not None and not r.alias_info.is_write
                     for r in rets)) \
            or torch.Tag.inplace_view in func.tags \
            or packet.startswith(("empty", "new_empty")):
        kind = "free"
    elif packet in GATHERS:
        kind = "gather"
    elif packet in SCATTERS:
        kind = "scatter"
    else:
        kind = "general"
    written = tuple(
        (a.name, not a.is_out and packet not in OVERWRITES)
        for a in schema.arguments
        if a.alias_info is not None and a.alias_info.is_write)
    return _OpInfo(func, str(func), kind, written)


def _bind(func, args, kwargs):
    bound = dict(zip((a.name for a in func._schema.arguments), args))
    bound.update(kwargs)
    return bound


def _tensors(value):
    """The tensors in ``value``, also inside dataclasses (``SparseVoxels``,
    which a module takes and returns)."""
    out = []
    for leaf in tree_leaves(value):
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            out += _tensors([getattr(leaf, f.name)
                             for f in dataclasses.fields(leaf)])
    return out


def _identity(t):
    """Two operands are one when they are the same elements of one
    storage."""
    return t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype


def _storage(t):
    return t.untyped_storage().data_ptr()


def _indexed_numel(shape, indices):
    """Elements that ``self[indices]`` addresses (a boolean index counts
    its true elements: a host sync)."""
    n, dim, shapes = 1, 0, []
    for ix in indices:
        if ix is None:
            n *= shape[dim]
            dim += 1
        elif ix.dtype == torch.bool:
            shapes.append((int(ix.sum()),))
            dim += ix.dim()
        else:
            shapes.append(tuple(ix.shape))
            dim += 1
    for size in torch.broadcast_shapes(*shapes) if shapes else ():
        n *= size
    for size in shape[dim:]:
        n *= size
    return n


class Tally:
    """What one counting context counted. FLOPs: ``kernels`` (by kernel
    name), :meth:`aten_flops` (the aten products outside the kernels).
    Bytes: ``kernel_bytes`` (by kernel name), :meth:`aten_bytes`,
    :meth:`total_bytes`, ``groups`` and ``group_ops`` (bytes and charges by
    mechanism key), ``backward_bytes`` (charged inside the backward) and,
    with ``log``, ``ops``: one ``(seq, op or kernel, operands, results,
    bytes, key)`` a charge, whose bytes sum to :meth:`total_bytes`."""

    def __init__(self, device=None, log=False):
        from torch.utils.flop_counter import FlopCounterMode
        from torch.utils.module_tracker import ModuleTracker

        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.mode = FlopCounterMode(display=False)
        self.kernels = collections.Counter()
        self.inside_wrappers = 0  # aten FLOPs counted while a wrapper ran
        self.kernel_bytes = collections.Counter()
        self.groups = collections.Counter()
        self.group_ops = collections.Counter()
        self.backward_bytes = 0
        self.ops = [] if log else None
        self.tracker = ModuleTracker()
        self.scopes = []      # function scopes open now (:func:`scoped`)
        self.node_keys = {}   # autograd node -> the key of its forward code
        self.wrapper_depth = 0
        self._aten_bytes = 0

    def aten_flops(self):
        return self.mode.get_total_flops() - self.inside_wrappers

    def kernel_flops(self):
        return sum(self.kernels.values())

    def total(self):
        return self.kernel_flops() + self.aten_flops()

    def aten_bytes(self):
        return self._aten_bytes

    def total_bytes(self):
        return self._aten_bytes + sum(self.kernel_bytes.values())

    # ------------------------------------------------------------ bytes
    def _on(self, t):
        return isinstance(t, torch.Tensor) and \
            t.device.type == self.device.type and \
            (self.device.index is None or t.device.index == self.device.index)

    def _bytes(self, t):
        return touched(t) if self._on(t) else 0

    def key(self):
        """The mechanism key of a charge made now: in the forward the
        innermost module's path and the open scopes; in the backward that
        of the forward code that made the running autograd node."""
        if torch._C._current_graph_task_id() != -1:
            node = torch._C._current_autograd_node()
            return BWD + self.node_keys.get(node, "Global")
        inner = max(self.tracker.parents,
                    key=lambda p: (p != "Global", p.count("."), p))
        return "/".join([inner.replace(".", "/"), *self.scopes])

    def claim(self, tensors, key):
        """Gives ``key`` to every autograd node behind ``tensors`` that no
        module or scope has claimed yet. Called with the enclosing key as a
        module or scope is entered (on its inputs) and with its own as it
        returns (on its outputs), this keys each node by the code that made
        it, so that the backward's charges land on the forward's
        mechanisms (``ModuleTracker``'s own backward tracking leaves a
        module marked active when the gradient of one of its inputs never
        comes)."""
        stack = [t.grad_fn for t in _tensors(tensors)]
        while stack:
            node = stack.pop()
            if node is None or node in self.node_keys:
                continue
            self.node_keys[node] = key
            stack.extend(n for n, _ in node.next_functions)

    @contextlib.contextmanager
    def claiming(self):
        """Claims each module's nodes (see :meth:`claim`); entered before
        the tracker, so that these hooks see the key outside the module as
        it is entered and inside it as it returns."""
        from torch.nn.modules.module import (
            register_module_forward_hook,
            register_module_forward_pre_hook,
        )

        pre = register_module_forward_pre_hook(
            lambda mod, args: self.claim(args, self.key()))
        post = register_module_forward_hook(
            lambda mod, args, out: self.claim(out, self.key()))
        try:
            yield
        finally:
            pre.remove()
            post.remove()

    def _add(self, nbytes, name, operands, results, key):
        self.groups[key] += nbytes
        self.group_ops[key] += 1
        if key.startswith(BWD):
            self.backward_bytes += nbytes
        if self.ops is not None:
            def desc(ts):
                return " ".join(describe(t) + ("" if self._on(t) else
                                               f"@{t.device.type}")
                                for t in ts) or "-"
            self.ops.append((len(self.ops), name, desc(operands),
                             desc(results), nbytes, key))

    def charge_op(self, info, args, kwargs, out):
        operands, results = _tensors((args, kwargs)), _tensors(out)
        nbytes = 0 if info.kind == "free" else \
            self._op_bytes(info, args, kwargs, operands, results)
        self._aten_bytes += nbytes
        self._add(nbytes, info.name, operands, results, self.key())

    def _distinct(self, tensors):
        seen, total = set(), 0
        for t in tensors:
            k = _identity(t)
            if k not in seen:
                seen.add(k)
                total += self._bytes(t)
        return total

    def _op_bytes(self, info, args, kwargs, operands, results):
        if info.kind == "gather":  # the source (argument 0) is not read whole
            return self._distinct(operands[1:]) + \
                2 * sum(self._bytes(t) for t in results)
        bound = _bind(info.func, args, kwargs)
        if info.kind == "scatter":
            return self._scatter_bytes(info.func._overloadpacket.__name__,
                                       bound)
        if not info.written:
            ptrs = {_storage(t) for t in operands}
            if results and all(_storage(t) in ptrs for t in results):
                return 0  # a view that the schema does not declare
        dest, read = [], []
        for name, reads in info.written:
            for t in _tensors(bound.get(name)):
                dest.append(t)
                if reads:
                    read.append(t)
        written = {_identity(t) for t in dest}
        ptrs = {_storage(t) for t in dest}
        return (self._distinct(read) + self._distinct(dest)
                + self._distinct([t for t in operands
                                  if _identity(t) not in written])
                + self._distinct([t for t in results
                                  if _storage(t) not in ptrs]))

    def _scatter_bytes(self, packet, bound):
        dest = bound["self"]
        if packet == "index_put_":
            indices = _tensors(bound["indices"])
            n = _indexed_numel(dest.shape, bound["indices"])
            read = self._bytes(bound["values"])
            accumulate = bool(bound.get("accumulate", False))
        else:
            indices = [bound["index"]]
            if packet.startswith("scatter"):
                n = bound["index"].numel()
                src = bound.get("src")
                read = n * src.element_size() if self._on(src) else 0
            elif packet == "index_fill_":
                dim = bound["dim"] % max(dest.dim(), 1)
                n = bound["index"].numel() * (
                    dest.numel() // max(dest.shape[dim], 1)
                    if dest.dim() else 1)
                read = self._bytes(bound["value"])
            else:  # index_add_, index_copy_
                n = bound["source"].numel()
                read = self._bytes(bound["source"])
            accumulate = packet in ("scatter_add_", "scatter_reduce_",
                                    "index_add_") or \
                bound.get("reduce") is not None
        write = n * dest.element_size() if self._on(dest) else 0
        return self._distinct(indices) + read + write * (1 + accumulate)

    def charge_kernel(self, name, nbytes, args, kwargs, out):
        self.kernel_bytes[name] += nbytes
        self._add(nbytes, f"kernel:{name}", _tensors((args, kwargs)),
                  _tensors(out), f"{self.key()} [{name}]")


class _ByteMode(TorchDispatchMode):
    """Charges each aten op that runs outside a kernel wrapper to its
    tally (see the module docstring)."""

    def __init__(self, tally):
        super().__init__()
        self.tally = tally
        self.info = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tally = self.tally
        if tally.wrapper_depth == 0:
            info = self.info.get(func)
            if info is None:
                info = self.info[func] = _op_info(func)
            tally.charge_op(info, args, kwargs, out)
        return out


_TALLY = None  # the open counting context's Tally


@contextlib.contextmanager
def counting(device=None, log=False):
    """Count the FLOPs and the bytes on ``device`` (default: the card when
    there is one, else the CPU) of what runs inside (see the module
    docstring); ``log`` keeps one entry a charge in ``tally.ops``."""
    global _TALLY
    if _TALLY is not None:
        raise RuntimeError("a counting context is already open")
    tally = Tally(device, log)
    _TALLY = tally
    try:
        with tally.mode, tally.claiming(), tally.tracker, _ByteMode(tally):
            yield tally
    finally:
        _TALLY = None


def scoped(name, fn):
    """``fn`` with its charges under ``<module path>/name`` inside a
    counting context (the backward of what it made included)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        tally = _TALLY
        if tally is None:
            return fn(*args, **kwargs)
        tally.claim((args, kwargs), tally.key())
        tally.scopes.append(name)
        try:
            out = fn(*args, **kwargs)
            tally.claim(out, tally.key())
        finally:
            tally.scopes.pop()
        return out
    return call


def counted(name, formula):
    """Decorates the wrapper of kernel ``name``: inside a counting context
    each of its calls adds ``formula(*args)``'s FLOPs and bytes under
    ``name``, in place of whatever aten work ran inside it (its plain
    version on CPU tensors; around a launch, allocations and casts).
    The decorated wrapper carries ``(name, formula)`` as ``.counted``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            tally = _TALLY
            if tally is None:
                return fn(*args, **kwargs)
            before = tally.mode.get_total_flops()
            tally.wrapper_depth += 1
            try:
                out = fn(*args, **kwargs)
                w = formula(*args, **kwargs)
            finally:
                tally.wrapper_depth -= 1
            tally.inside_wrappers += tally.mode.get_total_flops() - before
            tally.kernels[name] += w.flops
            tally.charge_kernel(name, w.nbytes, args, kwargs, out)
            return out
        call.counted = (name, formula)
        return call
    return wrap
