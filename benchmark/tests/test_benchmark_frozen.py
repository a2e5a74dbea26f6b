"""The frozen copies under ``benchmark/`` agree today with the port's
originals on small inputs, and the generators are deterministic per seed.
(These tests may import the port; the reference may not.)"""

import numpy as np
import pytest
import torch

from benchmark.harness import spec, trace, work
from benchmark.traffic import waymo_scene

WAYMO = spec.load_json(spec.BENCH / "rehearsal" / "mssvt-waymo.json")


def test_waymo_scene_is_the_ports_recipe():
    from mssvt_tpu_torch.datasets.synthetic_scene import (
        make_waymo_scale_scene,
    )

    grid = (48, 48, 8)
    for seed in (0, 3):
        want, n = make_waymo_scale_scene(4096, grid, seed=seed, batch=2)
        rng = np.random.default_rng(seed)
        got, m = waymo_scene.waymo_scale_scene(rng, 4096, grid, 2, 80_000, 5,
                                               5)
        assert n == m
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_generator_is_deterministic_per_seed():
    gen, config = waymo_scene, WAYMO
    params = config["traffic"]["params"]
    a, la = gen.make(params, config, 2, 2**31 + 17)
    b, lb = gen.make(params, config, 2, 2**31 + 17)
    c, _ = gen.make(params, config, 2, 2**31 + 18)
    assert la == lb and len(a) == params["distinct_batches"]
    for x, y, z in zip(a, b, c):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
        assert not np.array_equal(x["voxels"], z["voxels"])


def test_k3_formula_and_peaks_are_the_ports():
    from mssvt_tpu_torch.kernels import work as port

    assert (work.MEM_BPS, work.BF16_FLOPS, work.F32_FLOPS) == \
        (port.MEM_BPS, port.BF16_FLOPS, port.F32_FLOPS)
    nw, n1, nk1, nk2, d, nq = 12, 24, 8, 8, 64, 16
    args = (torch.zeros(nw, n1, d), torch.zeros(nw, nk2, d),
            torch.zeros(nw, nk1, dtype=torch.int32),
            torch.zeros(nw, nk1, dtype=torch.bool), None,
            torch.zeros(nw, nq), None, None, None, None, None, None, (2, 2),
            0.1, True)
    for fn in ("attention", "attention_bwd"):
        extra = (torch.zeros(nw, nq, d),) if fn == "attention_bwd" else ()
        a = getattr(work, fn)(*args[:12], *extra, *args[12:], nq=nq,
                              num_valid=torch.tensor(9))
        b = getattr(port, fn)(*args[:12], *extra, *args[12:], nq=nq,
                              num_valid=torch.tensor(9))
        assert a == b


def test_families_are_the_ports():
    import importlib.util

    path = spec.ROOT / "tools" / "profile_top_ops_torch.py"
    s = importlib.util.spec_from_file_location("profile_top_ops_torch", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    assert trace.FAMILIES == mod.FAMILIES
    assert trace.DEVICE_CATS == mod.DEVICE_CATS
