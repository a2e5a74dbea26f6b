"""Edge cases of PointNet++'s ball query, and a numpy oracle, shared by the
CPU tests (``test_torch_pointnet2.py``) and the card tests
(``test_torch_cuda.py``). Imports nothing of JAX.

Each case is (radius, nsample, xyz (B, N, 3) f32, new_xyz (B, M, 3) f32,
valid (B, N) bool or None), seeded. N = 2 085 walks two whole tiles of the
kernel's 1 024 points and a ragged third, and M = 45 leaves a ragged block
of queries (16 a CTA).
"""

import numpy as np

EDGE_CASES = ("all_empty", "all_in_ball", "nsample_over_n", "ragged_n",
              "boundary", "all_invalid")


def edge_case(name):
    rng = np.random.default_rng(EDGE_CASES.index(name) + 100)

    def cloud(b, n, lo, hi):
        return rng.uniform(lo, hi, (b, n, 3)).astype(np.float32)

    if name == "all_empty":  # every query far from every point
        return 0.5, 16, cloud(2, 300, 0.0, 1.0), cloud(2, 37, 50.0, 60.0), \
            None
    if name == "all_in_ball":  # every point inside every ball
        return 1.0, 32, cloud(2, 300, 0.0, 0.1), cloud(2, 37, 0.0, 0.1), \
            None
    if name == "nsample_over_n":  # fewer points than slots
        xyz = cloud(2, 20, 0.0, 0.3)
        xyz[:, 5:9] += 10.0
        return 0.9, 32, xyz, cloud(2, 37, 0.0, 0.3), None
    if name == "ragged_n":  # three tiles, the last ragged; ragged queries
        xyz = cloud(2, 2085, 0.0, 4.0)
        q = xyz[:, rng.integers(0, 2085, 45)] + rng.normal(
            size=(2, 45, 3)).astype(np.float32) * 0.3
        valid = rng.uniform(size=(2, 2085)) < 0.8
        return 0.6, 16, xyz, q, valid
    if name == "boundary":  # d2 == r2 exactly is no hit, one ulp below is
        r = 0.5
        below = np.nextafter(np.float32(r), np.float32(0))
        xs = np.array([r, below, -r, r + 1e-3, -below, 0.0], np.float32)
        xyz = np.zeros((2, 6, 3), np.float32)
        xyz[0, :, 0] = xs
        xyz[1, :, 2] = xs
        return r, 8, xyz, np.zeros((2, 3, 3), np.float32), None
    if name == "all_invalid":  # every support row invalid
        return 0.8, 16, cloud(2, 300, 0.0, 1.0), cloud(2, 37, 0.0, 1.0), \
            np.zeros((2, 300), bool)
    raise KeyError(name)


def oracle(radius, nsample, xyz, new_xyz, valid=None):
    """The contract by a loop over the queries: numpy f32 arithmetic in
    the plain version's order, the first ``nsample`` hits by ``nonzero``."""
    b, m = new_xyz.shape[:2]
    r2 = np.float32(radius ** 2)
    idx = np.zeros((b, m, nsample), np.int32)
    empty = np.zeros((b, m), bool)
    for i in range(b):
        for j in range(m):
            d = new_xyz[i, j][None, :] - xyz[i]
            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            hit = d2 < r2
            if valid is not None:
                hit &= valid[i]
            picks = np.nonzero(hit)[0][:nsample]
            empty[i, j] = picks.size == 0
            if picks.size:
                idx[i, j] = picks[0]
                idx[i, j, :picks.size] = picks
    return idx, empty
