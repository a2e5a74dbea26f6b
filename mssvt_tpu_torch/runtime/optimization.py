"""Optimizers and learning-rate schedules (torch counterpart of
``mssvt_tpu/runtime/optimization.py``, which builds optax chains).

:class:`ChainOptimizer` applies, in optax's order and arithmetic, the chain
the JAX package builds:

- ``adam_onecycle`` / ``adamw_onecycle``: ``clip_by_global_norm`` ->
  ``scale_by_adam(b1=mom(count), b2=0.99, eps=1e-8)`` ->
  ``add_decayed_weights(wd)`` -> ``-lr(count)``, where ``count`` is the step
  before its increment (as ``optax.inject_hyperparams`` evaluates the
  schedules) and the bias correction uses the current b1;
- ``adam`` (b1 0.9, b2 0.999), ``adamw`` (the same plus decoupled decay)
  and ``sgd`` (``optax.trace`` momentum) on the step-decay schedule.

The clip scales by ``max / |g|`` only when ``|g| >= max`` (``g / |g| * max``,
no epsilon), which is not what ``torch.nn.utils.clip_grad_norm_`` does.
Parameters are updated in place; gradients a parameter did not receive
count as zero, as JAX's would be. Schedules are float32 tensor arithmetic,
as the jnp versions trace.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch


def annealing_cos(start, end, pct):
    """fastai cosine annealing from ``start`` to ``end`` over pct in [0, 1]."""
    cos_out = torch.cos(math.pi * pct) + 1
    return end + (start - end) / 2 * cos_out


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def one_cycle_schedules(lr_max, total_steps, moms=(0.95, 0.85),
                        div_factor=10.0, pct_start=0.4):
    """(lr(step), b1(step)): cosine one-cycle over the learning rate and
    Adam's beta1, each returning a float32 scalar tensor."""
    lr_low = lr_max / div_factor
    lr_final = lr_max / (div_factor * 1e4)
    split = pct_start * total_steps

    def _phase(step, a0, a1, b0, b1):
        step = torch.clamp(_f32(step), max=float(total_steps))
        pct_w = step / max(split, 1.0)
        pct_a = (step - split) / max(total_steps - split, 1.0)
        return torch.where(
            step < split,
            annealing_cos(a0, a1, torch.clamp(pct_w, 0.0, 1.0)),
            annealing_cos(b0, b1, torch.clamp(pct_a, 0.0, 1.0)))

    def lr_fn(step):
        return _phase(step, lr_low, lr_max, lr_max, lr_final)

    def mom_fn(step):
        return _phase(step, moms[0], moms[1], moms[1], moms[0])

    return lr_fn, mom_fn


def decay_step_schedule(lr, decay_step_list, lr_decay, lr_clip,
                        total_iters_per_epoch, warmup=False, warmup_epoch=1):
    """Epoch-threshold step decay with a floor and optional linear warmup."""

    def lr_fn(step):
        epoch = _f32(step) / max(total_iters_per_epoch, 1)
        cur = _f32(lr)
        for threshold in decay_step_list:
            cur = torch.where(epoch >= threshold, cur * lr_decay, cur)
        cur = torch.clamp(cur, min=lr_clip)
        if warmup:
            warm = torch.clamp(lr * epoch / max(warmup_epoch, 1e-6),
                               min=lr_clip)
            cur = torch.where(epoch < warmup_epoch, warm, cur)
        return cur

    return lr_fn


class ChainOptimizer:
    """An optax-style gradient chain over named float32 parameters."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], kind: str,
                 lr_fn: Callable, b1_fn: Optional[Callable] = None,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip: float = 0.0,
                 momentum: float = 0.9):
        assert kind in ("adam", "sgd")
        self.params = dict(params)
        self.kind = kind
        self.lr_fn, self.b1_fn = lr_fn, b1_fn or (lambda step: _f32(0.9))
        self.b2, self.eps = b2, eps
        self.weight_decay, self.clip, self.momentum = weight_decay, clip, momentum
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = ({n: torch.zeros_like(p) for n, p in self.params.items()}
                   if kind == "adam" else {})

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    def grads(self):
        return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                for n, p in self.params.items()}

    @staticmethod
    def global_norm(grads):
        return torch.sqrt(sum((g.float() * g.float()).sum()
                              for g in grads.values()))

    @torch.no_grad()
    def step(self):
        """One update from the parameters' ``.grad``; returns the global
        gradient norm before clipping."""
        g = self.grads()
        g_norm = self.global_norm(g)
        if self.clip > 0:
            keep = g_norm < self.clip
            g = {n: torch.where(keep, x, (x / g_norm) * self.clip)
                 for n, x in g.items()}
        dev = next(iter(self.params.values())).device
        lr = self.lr_fn(self.count).to(dev)
        count_inc = self.count + 1
        for n, p in self.params.items():
            if self.kind == "adam":
                b1 = self.b1_fn(self.count).to(dev)
                self.mu[n] = (1 - b1) * g[n] + b1 * self.mu[n]
                self.nu[n] = (1 - self.b2) * (g[n] * g[n]) + self.b2 * self.nu[n]
                mu_hat = self.mu[n] / (1 - b1 ** float(count_inc))
                nu_hat = self.nu[n] / (1 - _f32(self.b2).to(dev)
                                       ** float(count_inc))
                u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            else:
                self.mu[n] = g[n] + self.momentum * self.mu[n]
                u = self.mu[n]
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * (-lr))
        self.count = count_inc
        return g_norm

    def state_dict(self):
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        for n, p in self.params.items():
            self.mu[n] = state["mu"][n].to(p.device)
            if self.kind == "adam":
                self.nu[n] = state["nu"][n].to(p.device)


def build_optimizer(opt_cfg, params, total_steps, steps_per_epoch):
    """(optimizer, lr_fn) for ``OPTIMIZATION`` of a config; ``params`` are
    the model's named parameters."""
    name = opt_cfg["OPTIMIZER"]
    lr = float(opt_cfg["LR"])
    wd = float(opt_cfg.get("WEIGHT_DECAY", 0.0))
    clip = float(opt_cfg.get("GRAD_NORM_CLIP", 0.0))
    params = dict(params)
    if name in ("adam_onecycle", "adamw_onecycle"):
        lr_fn, mom_fn = one_cycle_schedules(
            lr, total_steps, moms=tuple(opt_cfg.get("MOMS", [0.95, 0.85])),
            div_factor=float(opt_cfg.get("DIV_FACTOR", 10.0)),
            pct_start=float(opt_cfg.get("PCT_START", 0.4)))
        return ChainOptimizer(params, "adam", lr_fn, b1_fn=mom_fn, b2=0.99,
                              weight_decay=wd, clip=clip), lr_fn
    if name in ("adam", "adamw", "sgd"):
        lr_fn = decay_step_schedule(
            lr, decay_step_list=list(opt_cfg.get("DECAY_STEP_LIST", [])),
            lr_decay=float(opt_cfg.get("LR_DECAY", 0.1)),
            lr_clip=float(opt_cfg.get("LR_CLIP", 1e-7)),
            total_iters_per_epoch=steps_per_epoch,
            warmup=bool(opt_cfg.get("LR_WARMUP", False)),
            warmup_epoch=int(opt_cfg.get("WARMUP_EPOCH", 1)))
        if name == "sgd":
            return ChainOptimizer(params, "sgd", lr_fn, clip=clip,
                                  momentum=float(opt_cfg.get("MOMENTUM", 0.9))
                                  ), lr_fn
        return ChainOptimizer(params, "adam", lr_fn, b2=0.999,
                              weight_decay=wd if name == "adamw" else 0.0,
                              clip=clip), lr_fn
    raise NotImplementedError(name)
