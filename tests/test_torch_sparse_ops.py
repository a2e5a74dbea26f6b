"""Left-overs of the port's sparse core and ops against the JAX package on
the CPU: the on-device voxelizer (``voxelize_points_torch`` vs
``voxelize_points_jax``), ``SparseVoxels.per_sample`` / ``dense`` /
``metric_centers``, and ``PosProjection.__call__`` / ``from_planes``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu.core.sparse import SparseVoxels as JSV
from mssvt_tpu.ops.voxelize import voxelize_points_jax
from mssvt_tpu_torch.core.sparse import SparseVoxels as TSV
from mssvt_tpu_torch.ops.voxelize import (
    voxelize_points,
    voxelize_points_torch,
)

VOXEL_SIZE = (0.5, 0.5, 0.5)
PCR = (0.0, 0.0, 0.0, 4.0, 4.0, 4.0)

torch.set_num_threads(2)


# voxelizer cases: (points, padded to, max points a voxel, max voxels, pcr,
# voxel size); the second drops voxels at the cap and points past the
# per-voxel cap, the third is mssvt_tiny.yaml's grid
VOX_CASES = [
    (300, 512, 4, 256, PCR, VOXEL_SIZE),
    (2000, 2048, 3, 100, PCR, VOXEL_SIZE),
    (3000, 3000, 5, 2048, (0.0, -9.6, -2.0, 19.2, 9.6, 2.0), (0.4, 0.4, 0.5)),
]


@pytest.mark.parametrize("case", range(len(VOX_CASES)))
def test_voxelize_points_torch_equals_jax(case):
    """Voxels, coords, counts and mask exactly equal to
    ``voxelize_points_jax`` (padding rows invalid, some points out of
    range), as ``tests/test_pipeline.py`` holds the JAX version against the
    host one; and the same voxel set and counts as the host voxelizer."""
    n, pad_to, p, mv, pcr, vs = VOX_CASES[case]
    rng = np.random.default_rng(case)
    lo, hi = np.asarray(pcr[:3]) - 0.5, np.asarray(pcr[3:]) + 0.5
    pts = np.concatenate([rng.uniform(lo, hi, (n, 3)),
                          rng.normal(size=(n, 2))], 1).astype(np.float32)
    pad = np.zeros((pad_to, 5), np.float32)
    pad[:n] = pts
    pad[n:, :3] = rng.uniform(lo, hi, (pad_to - n, 3))  # invalid, in range
    valid = np.arange(pad_to) < n
    want = voxelize_points_jax(jnp.asarray(pad), jnp.asarray(valid), vs, pcr,
                               p, mv)
    got = voxelize_points_torch(torch.as_tensor(pad), torch.as_tensor(valid),
                                vs, pcr, p, mv)
    for name, g, w in zip(("voxels", "coords", "num_points", "vmask"), got,
                          want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    _, hc, hn = voxelize_points(pts, vs, pcr, p, 10**6, use_native=False)
    m = got[3].numpy()
    host = {tuple(c): min(k, p) for c, k in zip(hc, hn)}
    dev = {tuple(c[1:]): k for c, k in zip(got[1].numpy()[m],
                                            got[2].numpy()[m])}
    if len(host) <= mv:
        assert dev == host
    else:  # the first mv voxels in sorted-key order
        keep = sorted(host, key=lambda c: (c[0], c[1], c[2]))[:mv]
        assert dev == {c: host[c] for c in keep}


def _sparse_pair(rng, compacted):
    """One sparse tensor on both sides: 3 frames in per-frame slots, or
    globally compacted rows in mixed frame order (a strided conv's sites)."""
    b, per, c = 3, 40, 6
    grid = (16, 12, 4)
    coords = np.full((b * per, 4), -1, np.int32)
    valid = np.zeros(b * per, bool)
    for i in range(b):
        cells = np.unique(np.stack([
            rng.integers(0, grid[2], 30), rng.integers(0, grid[1], 30),
            rng.integers(0, grid[0], 30)], 1), axis=0)[:per - 3 * i]
        k = len(cells)
        coords[i * per:i * per + k, 0] = i
        coords[i * per:i * per + k, 1:] = cells
        valid[i * per:i * per + k] = True
    if compacted:
        order = np.concatenate([rng.permutation(np.flatnonzero(valid)),
                                np.flatnonzero(~valid)])
        coords, valid = coords[order], valid[order]
    feats = (rng.normal(size=(b * per, c)) * valid[:, None]).astype(np.float32)
    geo = dict(batch_size=b, spatial_shape=grid, voxel_size=(0.2, 0.3, 0.5),
               point_cloud_range=(-1.0, 2.0, -3.0, 2.2, 5.6, -1.0))
    j = JSV.create(features=jnp.asarray(feats), coords=jnp.asarray(coords),
                   valid=jnp.asarray(valid), **geo)
    t = TSV.create(torch.as_tensor(feats), torch.as_tensor(coords),
                   torch.as_tensor(valid), **geo)
    return j, t


@pytest.mark.parametrize("compacted", [False, True])
@pytest.mark.parametrize("max_per_sample", [None, 25])
def test_per_sample_equals_jax(compacted, max_per_sample):
    """``per_sample`` (metric centres, features, valid per frame, rows
    past ``max_per_sample`` dropped) exactly as JAX's."""
    j, t = _sparse_pair(np.random.default_rng(4), compacted)
    want = j.per_sample(max_per_sample)
    got = t.per_sample(max_per_sample)
    for name, g, w in zip(("xyz", "features", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(t.metric_centers().numpy(),
                                  np.asarray(j.metric_centers()))


@pytest.mark.parametrize("channels_last", [True, False])
def test_dense_equals_jax(channels_last):
    j, t = _sparse_pair(np.random.default_rng(5), True)
    np.testing.assert_array_equal(t.dense(channels_last).numpy(),
                                  np.asarray(j.dense(channels_last)))


@pytest.mark.parametrize("deep", [False, True])
def test_pos_projection_call_and_from_planes_match_flax(deep):
    """``forward`` on (NW, n, 6) stacks (shallow and deep) and
    ``from_planes`` on planes (shallow) against flax's ``__call__`` and
    ``from_planes`` on the same weights, to 1e-5 (f32; the plane form sums
    the same products in another order)."""
    import jax

    from mssvt_tpu.models.model_utils.layers import PosProjection as JPos
    from mssvt_tpu_torch.bridge import load_flax_variables
    from mssvt_tpu_torch.models.model_utils.layers import PosProjection

    rng = np.random.default_rng(6)
    nw, n, c = 5, 7, 16
    rel = [rng.normal(size=(nw, n)).astype(np.float32) for _ in range(3)]
    ctr = [rng.normal(size=(nw,)).astype(np.float32) * 10 for _ in range(3)]
    x = np.concatenate([np.stack(rel, -1),
                        np.broadcast_to(np.stack(ctr, -1)[:, None], (nw, n, 3))],
                       -1).astype(np.float32)
    jm = JPos(c, deep=deep)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables["params"] = jax.tree_util.tree_map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1,
        variables["params"])
    tm = PosProjection(c, deep=deep)
    load_flax_variables(tm, variables)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if not deep:
        with jax.default_matmul_precision("float32"):
            want_p = np.asarray(jm.apply(
                variables, *map(jnp.asarray, rel + ctr),
                method=JPos.from_planes))
        with torch.no_grad():
            got_p = tm.from_planes(*map(torch.as_tensor, rel + ctr)).numpy()
        np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_p, got, rtol=1e-5, atol=1e-5)
