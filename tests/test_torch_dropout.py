"""Attention and FFN dropout above 0 in training, against the JAX package.

JAX draws its masks with ``jax.random.bernoulli`` (flax's ``nn.Dropout``
``attn_drop_i``/``proj_drop_i``/``dropout1``), the port with
``layers.keep_mask`` on a ``torch.Generator``; the two streams cannot be
matched, so the masks are injected: each JAX draw is replaced by a seeded
numpy mask of the asked shape and probability, recorded, and the port's
draws are served the recorded masks in order (which also holds the two
draw orders equal). A statistical check covers the port's own draws, and
rate 0 keeps the kernel routes and draws nothing.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mssvt_tpu_torch.models.model_utils import layers as t_layers

ROOT = Path(__file__).resolve().parent.parent
TINY_YAML = ROOT / "tools" / "cfgs" / "synthetic_models" / "mssvt_tiny.yaml"

torch.set_num_threads(2)


class Masks:
    """Seeded masks: ``jax_draw`` replaces ``jax.random.bernoulli`` and
    records; ``port_draw`` replaces ``layers.keep_mask`` and replays."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.drawn, self.served = [], 0

    def jax_draw(self, key, p=0.5, shape=None):
        m = self.rng.random(tuple(shape)) < p
        self.drawn.append((tuple(shape), float(p), m))
        return jnp.asarray(m)

    def port_draw(self, shape, keep, generator, device):
        want_shape, p, m = self.drawn[self.served]
        assert tuple(shape) == want_shape and abs(keep - p) < 1e-6, (
            self.served, tuple(shape), want_shape, keep, p)
        self.served += 1
        return torch.as_tensor(m, device=device)


@pytest.mark.parametrize("nq", [1, 8])
def test_attention_dropout_matches_flax_with_injected_masks(nq, monkeypatch):
    """``MixedScaleAttention`` in training at dropout 0.3 (nq = 1 as the
    compress blocks; nq = 8, where rate 0 would take K6/K7): outputs and
    every cotangent (inputs and per-group parameters) to 1e-5, four masks a
    call (two groups x attention weights, projection output)."""
    from mssvt_tpu.models.model_utils.attention import (
        MixedScaleAttention as JAttn,
    )
    from mssvt_tpu_torch.bridge import load_flax_variables, to_flax_tree
    from mssvt_tpu_torch.models.model_utils.attention import (
        MixedScaleAttention,
    )

    monkeypatch.setenv("MSSVT_PALLAS", "xla_fill")
    rng = np.random.default_rng(1)
    nw, nk, d, heads = 6, 16, 32, (2, 2)
    q = rng.normal(size=(nw, nq, d)).astype(np.float32)
    k = rng.normal(size=(nw, nk, d)).astype(np.float32)
    km = rng.random((nw, nk)) < 0.2
    qm = rng.random((nw, nq)) < 0.2
    g = rng.normal(size=(nw, nq, d)).astype(np.float32)
    jm = JAttn(embed_dim=d, num_heads=heads, dropout=0.3)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(q),
                                       jnp.asarray(k), jnp.asarray(qm),
                                       jnp.asarray(km)))
    masks = Masks(2)
    monkeypatch.setattr(jax.random, "bernoulli", masks.jax_draw)

    def f(params, q_, k_):
        return jm.apply({"params": params}, q_, k_, jnp.asarray(qm),
                        jnp.asarray(km), deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(3)})

    with jax.default_matmul_precision("float32"):
        want, vjp = jax.vjp(f, variables["params"], jnp.asarray(q),
                            jnp.asarray(k))
        wp, wq, wk = vjp(jnp.asarray(g))
    assert len(masks.drawn) == 4

    tm = MixedScaleAttention(d, heads, dropout=0.3).train()
    load_flax_variables(tm, variables)
    monkeypatch.setattr(t_layers, "keep_mask", masks.port_draw)
    tq = torch.as_tensor(q).requires_grad_()
    tk = torch.as_tensor(k).requires_grad_()
    out = tm(query=tq, keys=tk, query_mask=torch.as_tensor(qm),
             key_masks=torch.as_tensor(km), generator=torch.Generator())
    out.backward(torch.as_tensor(g))
    assert masks.served == 4
    close = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **close)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(wq), **close)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(wk), **close)
    got = to_flax_tree(tm, "params", grads=True)
    for (path, w) in jax.tree_util.tree_leaves_with_path(wp):
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(w), err_msg=str(path),
                                   **close)


def _tiny_backbone_pair(dropout):
    """The tiny config's 3D backbone on both sides (flax init carried into
    the port) and one seeded 2-frame sparse input."""
    from mssvt_tpu.config import cfg_from_yaml_file as j_cfg
    from mssvt_tpu.core.sparse import SparseVoxels as JSV
    from mssvt_tpu.models.backbones_3d.mssvt import (
        MixedScaleSparseTransformer as JB,
    )
    from mssvt_tpu.utils.edict import EasyDict as JDict
    from mssvt_tpu_torch.bridge import load_flax_variables
    from mssvt_tpu_torch.core.sparse import SparseVoxels as TSV
    from mssvt_tpu_torch.models.backbones_3d.mssvt import (
        MixedScaleSparseTransformer as TB,
    )

    cfg = j_cfg(str(TINY_YAML), JDict())
    params = [dict(p) for p in cfg.MODEL.BACKBONE_3D.PARAMS]
    grid, vs = (48, 48, 8), (0.4, 0.4, 0.5)
    pcr = tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    rng = np.random.default_rng(8)
    n, cap = 700, 1024
    coords = np.unique(np.stack([rng.integers(0, 2, n),
                                 rng.integers(0, grid[2], n),
                                 rng.integers(0, grid[1], n),
                                 rng.integers(0, grid[0], n)], 1),
                       axis=0).astype(np.int32)
    pad = np.full((cap, 4), -1, np.int32)
    pad[:len(coords)] = coords
    valid = np.arange(cap) < len(coords)
    feats = (rng.normal(size=(cap, 4)) * valid[:, None]).astype(np.float32)
    geo = dict(batch_size=2, spatial_shape=grid, voxel_size=vs,
               point_cloud_range=pcr)
    jsp = JSV.create(features=jnp.asarray(feats), coords=jnp.asarray(pad),
                     valid=jnp.asarray(valid), with_index=False, **geo)
    tsp = TSV.create(torch.as_tensor(feats), torch.as_tensor(pad),
                     torch.as_tensor(valid), **geo)
    jm = JB(params_cfg=tuple(params), dropout=dropout)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jsp))
    tm = TB(params, in_features=4, dropout=dropout)
    load_flax_variables(tm, variables)
    return jm, variables, jsp, tm, tsp


@pytest.fixture
def flush_denormal():
    """Denormals flushed to zero in this process for the test's duration."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_backbone_dropout_trains_like_flax_with_injected_masks(
        monkeypatch, flush_denormal):
    """The tiny 3D backbone (two MsSVT blocks, one compress block) in
    training at dropout 0.25: attention through the outside assembly and
    the per-group einsum, ``dropout1`` twice in each FFN, in JAX's draw
    order. Features within 1e-4 of their largest magnitude, parameter
    gradients per leaf to rtol 2e-4 and atol 1e-5 of the leaf's largest
    magnitude (f32 sums over every window of products up to ~50, in
    another order).

    The port runs with denormals flushed to zero, as XLA does on the CPU:
    with the flax init's zero biases, a compress window whose real keys'
    attention weights are all dropped keeps only pad keys (weight e^-100)
    and its output row is ~1e-39; the next block's LayerNorm divides such a
    row by sqrt(eps) = 1e-3, and whether its denormals count decides
    cotangents of size ~1e3."""
    from mssvt_tpu_torch.bridge import to_flax_tree

    monkeypatch.setenv("MSSVT_PALLAS", "xla_fill")
    jm, variables, jsp, tm, tsp = _tiny_backbone_pair(0.25)
    masks = Masks(4)
    monkeypatch.setattr(jax.random, "bernoulli", masks.jax_draw)

    def f(params):
        return jm.apply({"params": params}, jsp, deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1)}).features

    with jax.default_matmul_precision("float32"):
        want, vjp = jax.vjp(jax.jit(f), variables["params"])
        g = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
        (wp,) = vjp(jnp.asarray(g))
    # per MsSVT block 2 groups x 2 + 2 FFN draws, the compress block 1 x 2 + 2
    assert len(masks.drawn) == 6 + 4 + 6

    monkeypatch.setattr(t_layers, "keep_mask", masks.port_draw)
    tm.train()
    out = tm(tsp, generator=torch.Generator()).features
    out.backward(torch.as_tensor(g))
    assert masks.served == len(masks.drawn)
    want = np.asarray(want)
    err = np.abs(out.detach().numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err
    got = to_flax_tree(tm, "params", grads=True)
    n = 0
    for path, w in jax.tree_util.tree_leaves_with_path(wp):
        node = got
        for p in path:
            node = node[p.key]
        w = np.asarray(w)
        np.testing.assert_allclose(node, w, rtol=2e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=str(path))
        n += 1
    assert n > 30


def test_port_dropout_draws_keep_rate_and_scale():
    """The port's own draws: about ``1 - rate`` of the entries kept (within
    5 standard deviations), each kept entry scaled by 1 / (1 - rate), the
    rest zero; the same generator state repeats the mask; identity at eval
    and at rate 0."""
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    y = t_layers.dropout(x, 0.3, True, gen)
    kept = (y != 0).float().mean().item()
    sd = (0.7 * 0.3 / x.numel()) ** 0.5
    assert abs(kept - 0.7) < 5 * sd
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.7))
    gen.set_state(state)
    assert torch.equal(t_layers.dropout(x, 0.3, True, gen), y)
    assert t_layers.dropout(x, 0.3, False, gen) is x
    assert t_layers.dropout(x, 0.0, True, None) is x


def test_rate_zero_draws_nothing_and_keeps_the_kernel_routes(monkeypatch):
    """Dropout 0 (the configs' value): a training forward and backward of
    the tiny backbone draws no mask and runs the assembled attention
    Function (K3/K5 on the card) in both MsSVT blocks; at dropout 0.25 the
    eval forward equals dropout 0's exactly (dropout is off at eval, K4 and
    K3 run)."""
    from mssvt_tpu_torch.kernels import attention_bwd

    _, _, _, tm, tsp = _tiny_backbone_pair(0.0)
    calls = []
    apply = attention_bwd.AssembledAttention.apply
    monkeypatch.setattr(attention_bwd.AssembledAttention, "apply",
                        lambda *a: calls.append(1) or apply(*a))

    def no_draw(*a):
        raise AssertionError("a mask was drawn at rate 0")

    monkeypatch.setattr(t_layers, "keep_mask", no_draw)
    tm.train()
    tm(tsp, generator=torch.Generator()).features.sum().backward()
    assert len(calls) == 2
    _, _, _, tm_drop, _ = _tiny_backbone_pair(0.25)
    tm.eval()
    tm_drop.eval()
    with torch.no_grad():
        assert torch.equal(tm(tsp).features, tm_drop(tsp).features)
