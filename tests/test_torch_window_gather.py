"""The port's window gather (``ops/window.py``) on the routes the shipped
configurations do not take, against the JAX package route for route: the
candidate-scatter gather (``_gather_candidates``) against JAX's
``MSSVT_PALLAS=off`` path (a non-bijective query table without a batch
size, no batch size, buffers that are no runs of win2, single-scale
windows); a non-bijective table with a batch size through the own-cell
path (the box permuted to table order, the fill at ``order=None``) against
JAX's own-cell path with its XLA fill; and, on the shipped (bijective)
tables, the candidate path against the port's own-cell path. Every
buffer's rows, packed offsets, masks (and the even run's start, and the
voxel -> (window, slot) inverse where the path has one) exactly."""

from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mssvt_tpu.ops import window as j_window
from mssvt_tpu_torch.core.index import linearize_coords
from mssvt_tpu_torch.core.sparse import SparseVoxels
from mssvt_tpu_torch.models.backbones_3d.mssvt import (
    MixedScaleSparseTransformer,
)
from mssvt_tpu_torch.ops import window as t_window

GRID = (24, 24, 8)
B, V = 2, 512


def _voxels(seed, n=420):
    rng = np.random.default_rng(seed)
    coords = np.unique(np.stack([
        rng.integers(0, B, n), rng.integers(0, GRID[2], n),
        rng.integers(0, GRID[1], n), rng.integers(0, GRID[0], n)], 1),
        axis=0).astype(np.int32)
    pad = np.full((V, 4), -1, np.int32)
    pad[:len(coords)] = coords
    return pad, np.arange(V) < len(coords)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# (win1, win2, caps (win1, win2, odd, even), batch size given, buffers);
# win2 / win1 = 5/3: the cell decomposition is no bijection
OWN_CELL_CASES = {
    "non_bijective": ((3, 3, 4), (5, 5, 4), (20, 40, None, None), True, None),
    "non_bijective_buffers": ((3, 3, 4), (5, 5, 4), (12, 30, 6, 6), True,
                              ("even", "win1", "win2")),
}
CASES = {
    "non_bijective_no_batch": ((3, 3, 4), (5, 5, 4), (20, 40, None, None),
                               False, ("even", "win1", "win2")),
    "no_batch_size": ((3, 3, 4), (9, 9, 4), (24, 48, None, None), False,
                      None),
    # a win1 buffer wider than win2 and an even cap past win2: no runs
    "not_derivable": ((3, 3, 4), (9, 9, 4), (60, 48, 10, 40), True, None),
    "single_no_batch": ((2, 2, 4), None, (16, None, None, None), False, None),
}


def _compare_with_jax(case, seed):
    """The port's and JAX's ``gather_window_voxels`` on one case's voxels
    and tables: every key of every buffer equal; returns the port's
    output."""
    w1, w2, (c1, c2, codd, ceven), with_batch, buffers = {
        **CASES, **OWN_CELL_CASES}[case]
    coords, valid = _voxels(seed)
    jt = j_window.build_query_tables(w1, w2)
    tt = t_window.build_query_tables(w1, w2)
    np.testing.assert_array_equal(tt.pos_lut, jt.pos_lut)
    np.testing.assert_array_equal(tt.col_src, jt.col_src)
    assert (tt.inv_src is None) == case.startswith("non_bijective")
    maxw = 96
    jr = j_window.window_partition(jnp.asarray(coords), jnp.asarray(valid),
                                   GRID, w1, maxw, batch_size=B)
    tr = t_window.window_partition(torch.as_tensor(coords),
                                   torch.as_tensor(valid), GRID, w1, maxw, B)
    kw = dict(max_num_win1=c1, max_num_win2=c2, max_num_odd=codd,
              max_num_even=ceven, buffers=buffers, return_inverse=True,
              batch_size=B if with_batch else None)
    jg = j_window.gather_window_voxels(jr[0], jr[1], jnp.asarray(coords),
                                       jnp.asarray(valid), GRID, w1, jt, **kw)
    tg = t_window.gather_window_voxels(tr[0], tr[1], torch.as_tensor(coords),
                                       torch.as_tensor(valid), GRID, w1, tt,
                                       **kw)
    assert set(tg) == set(jg)
    hits = 0
    for name in tg:
        assert set(tg[name]) == set(jg[name]) - {"coord"}, name
        for key in tg[name]:
            np.testing.assert_array_equal(_np(tg[name][key]),
                                          np.asarray(jg[name][key]),
                                          err_msg=f"{name}/{key}")
        if name != "inv_win1":
            hits += int((_np(tg[name]["ind"]) >= 0).sum())
    assert hits > 100
    return tg


@pytest.mark.parametrize("case", sorted(CASES))
def test_candidate_gather_equals_jax_off_path(case, monkeypatch):
    monkeypatch.setenv("MSSVT_PALLAS", "off")
    tg = _compare_with_jax(case, sorted(CASES).index(case))
    assert ("inv_win1" in tg) == (case in ("no_batch_size",
                                           "non_bijective_no_batch"))


@pytest.mark.parametrize("case", sorted(OWN_CELL_CASES))
def test_non_bijective_own_cell_gather_equals_jax(case, monkeypatch):
    """A non-bijective table with a batch size takes the own-cell path on
    both sides (JAX: any fill mode but ``off``; here its XLA fill), never
    the candidate scatter."""
    monkeypatch.setenv("MSSVT_PALLAS", "xla_fill")

    def refuse(*args, **kw):
        raise AssertionError("took the candidate-scatter gather")

    monkeypatch.setattr(t_window, "_gather_candidates", refuse)
    tg = _compare_with_jax(case, 7 + sorted(OWN_CELL_CASES).index(case))
    assert "inv_win1" in tg and bool(tg["inv_win1"]["valid"].any())


@pytest.mark.parametrize("scales", ["two", "single"])
def test_candidate_gather_equals_own_cell_path(scales):
    """On the shipped, bijective tables both of the port's paths give the
    same buffers and inverse map."""
    coords, valid = _voxels(3)
    if scales == "two":
        w1, w2, caps = (3, 3, 4), (9, 9, 4), {"win1": 24, "win2": 48}
        names = ("odd", "even", "win1", "win2")
    else:
        w1, w2, caps, names = (2, 2, 4), None, {"win1": 16}, ("win1",)
    tt = t_window.build_query_tables(w1, w2)
    if w2 is not None:
        caps.update(odd=tt.num_odd, even=tt.num_even)
    tc, tv = torch.as_tensor(coords), torch.as_tensor(valid)
    wc, wv, wg, nv, vrow = t_window.window_partition(tc, tv, GRID, w1, 96, B,
                                                     return_ranks=True)
    own = t_window.gather_window_voxels(
        wc, wv, tc, tv, GRID, w1, tt, max_num_win1=caps["win1"],
        max_num_win2=caps.get("win2"), batch_size=B, return_inverse=True,
        num_valid=nv, voxel_win_row=vrow)
    cand = t_window._gather_candidates(wc, wv, tc, tv, wg, w1, tt, caps,
                                       names, B, True)
    for name in names:
        for key in ("ind", "coordp", "mask"):
            assert torch.equal(cand[name][key], own[name][key]), (name, key)
    if "inv_win1" in cand:  # two scales: the derived path's inverse
        for key in ("win_row", "slot", "valid"):
            a, b = cand["inv_win1"][key], own["inv_win1"][key]
            live = own["inv_win1"]["valid"]
            assert torch.equal(a[live], b[live]), key
        assert torch.equal(cand["inv_win1"]["valid"], own["inv_win1"]["valid"])


# the window sizes of mssvt.yaml's blocks: blocks 0 and 2, the compress
# blocks, block 4
MSSVT_WINDOWS = {"blocks_0_2": ((3, 3, 8), (9, 9, 8)),
                 "compress": ((2, 2, 4), None),
                 "block_4": ((3, 3, 2), (9, 9, 2))}


@pytest.mark.parametrize("name", sorted(MSSVT_WINDOWS))
def test_neighbour_windows_equal_the_list_index_form(name):
    """The own-cell gather's candidate windows (``neighbour_windows``, the
    deltas cached in (z, y, x) order) and their keys are the former list
    index's (``win_coords[:, None, [3, 2, 1]] + deltas``, flipped) exactly,
    padded window rows included."""
    w1, w2 = MSSVT_WINDOWS[name]
    tables = t_window.build_query_tables(w1, w2)
    coords, valid = _voxels(11)
    wc, wv, *_ = t_window.window_partition(
        torch.as_tensor(coords), torch.as_tensor(valid), GRID, w1, 600, B)
    assert bool(wv.any()) and not bool(wv.all())
    deltas = torch.as_tensor(tables.deltas, dtype=wc.dtype)
    d = deltas.shape[0]
    want = torch.cat([wc[:, None, 0:1].expand(wc.shape[0], d, 1),
                      (wc[:, None, [3, 2, 1]] + deltas[None]).flip(-1)], -1)
    got = t_window.neighbour_windows(wc, tables)
    assert torch.equal(got, want)
    grid = tuple(g // w for g, w in zip(GRID, w1))
    assert torch.equal(linearize_coords(got, grid, valid=wv[:, None]),
                       linearize_coords(want, grid, valid=wv[:, None]))


TINY_YAML = (Path(__file__).resolve().parent.parent / "tools" / "cfgs"
             / "synthetic_models" / "mssvt_tiny.yaml")


def _tiny_backbone():
    with open(TINY_YAML) as f:
        params = yaml.safe_load(f)["MODEL"]["BACKBONE_3D"]["PARAMS"]
    torch.manual_seed(0)
    return MixedScaleSparseTransformer(params, in_features=5).eval()


def _tiny_voxels():
    coords, valid = _voxels(5)
    feats = torch.randn(V, 5, generator=torch.Generator().manual_seed(5))
    return SparseVoxels.create(
        feats * torch.as_tensor(valid)[:, None], torch.as_tensor(coords),
        torch.as_tensor(valid), B, GRID, (0.4, 0.4, 0.5),
        (0.0, -4.8, -2.0, 9.6, 4.8, 2.0), with_index=False)


def _route(model, case):
    """(whether ``case`` would take the graph on the card, the forward's
    output on the CPU, its spans)."""
    sp = _tiny_voxels()
    gen = torch.Generator().manual_seed(1) if case == "generator" else None
    if case == "train":
        model.train()
    handles = []
    if case == "pre_hook_on_block":
        handles.append(model.blocks()[0].register_forward_pre_hook(
            lambda m, a: None))
    elif case == "hook_inside_block":
        handles.append(model.blocks()[0].norm1.register_forward_hook(
            lambda m, a, o: None))
    elif case == "hook_on_block":
        handles.append(model.blocks()[0].register_forward_hook(
            lambda m, a, o: None))
    elif case == "kwargs_hook_on_block":
        handles.append(model.blocks()[0].register_forward_hook(
            lambda m, a, k, o: None, with_kwargs=True))
    card_like = SimpleNamespace(
        features=SimpleNamespace(is_cuda=case != "cpu"), index=None)
    with torch.set_grad_enabled(case == "grad"):
        graphed = model._graphed(card_like, gen)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = model(sp, gen)
    for h in handles:
        h.remove()
    return graphed, out, {e.name for e in prof.events()}


# the route's conditions one at a time; the last three: plain forward
# hooks on a block are run after a replay, other hooks see the ops one by
# one
ROUTES = {"cpu": False, "train": False, "grad": False, "generator": False,
          "pre_hook_on_block": False, "hook_inside_block": False,
          "kwargs_hook_on_block": False, "hook_on_block": True,
          "card_eval_no_grad": True}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_backbone_graph_route(case):
    """Only an inference call on the card (eval, no autograd, no
    generator, no hook but plain forward hooks on the blocks) takes the CUDA
    graph; on the CPU every call runs the eager forward, opens no
    ``mssvt.backbone_graph`` span and keeps no graph."""
    model = _tiny_backbone()
    graphed, out, names = _route(model, case)
    assert graphed == ROUTES[case]
    assert not any(n.startswith("mssvt.backbone_graph") for n in names)
    assert model.graph.key is None
    model.eval()
    with torch.no_grad():
        want = model.stages(_tiny_voxels())[-1]
    if case in ("train", "generator", "grad"):
        assert out.features.shape == want.features.shape
    else:
        assert torch.equal(out.features, want.features)
    assert torch.equal(out.coords, want.coords)


def test_train_mode_drops_the_backbone_graphs():
    """Training never replays, so ``train()`` frees the graph; ``eval()``
    keeps it."""
    model = _tiny_backbone()
    model.graph.key, model.graph.captured = "key", "graph"
    model.eval()
    assert (model.graph.key, model.graph.captured) == ("key", "graph")
    model.train()
    assert (model.graph.key, model.graph.captured) == (None, None)
