"""An inference forward of a 3-D backbone as CUDA graphs (the MsSVT
backbone's one graph, the sparse-conv backbone's two).

:func:`graphable` is the route: a call takes the graphs only on the card,
in eval, with autograd off, no generator, no sorted-key index on the input
and nothing that would see the ops one by one (a dispatch mode, a hook),
except plain forward hooks on the modules a caller names, which a replay
runs after it on clones (the benchmark's judge keeps those modules'
outputs through them). :class:`ForwardGraph` keeps the graphs of the last
key seen.
"""

from __future__ import annotations

import contextlib
import itertools
import warnings
from dataclasses import dataclass, replace

import torch
from torch import nn
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

from .. import kernels
from ..core.index import VoxelIndex
from . import tracing


def graphable(module, sp, generator, hookable=()) -> bool:
    """Whether ``module(sp, generator)`` may replay its graphs: an eval
    forward on the card, and no hook but plain forward hooks on the
    modules in ``hookable`` (hooks on ``module`` itself run outside its
    forward)."""
    if not (sp.features.is_cuda and not module.training
            and not torch.is_grad_enabled() and generator is None
            and sp.index is None and not is_in_torch_dispatch_mode()):
        return False
    glob = nn.modules.module
    if glob._global_forward_hooks or glob._global_forward_pre_hooks:
        return False
    hookable = set(hookable)
    return not any(m._forward_pre_hooks or m._forward_hooks_with_kwargs
                   or (m._forward_hooks and m not in hookable)
                   for m in module.modules() if m is not module)


@dataclass
class _Graphs:
    graphs: list    # (span name or None, torch.cuda.CUDAGraph), in order
    inputs: tuple   # static features, coords, valid: the replays read them
    outputs: list   # each part's static outputs: the replays write them
    launches: dict  # kernel launches the capture counted (name -> count)


class ForwardGraph:
    """A forward as CUDA graphs, kept for the last key seen: the inputs'
    shapes, dtypes and device, the voxels' geometry and the data pointers
    of the module's parameters and buffers (a ``.to()`` or a replaced
    tensor captures anew; an in-place update keeps the graphs, whose
    replay reads the new values).

    The forward comes in ``parts``, ``(span, fn)`` pairs: ``fn(sp, prev)``
    takes the static input voxels and the part before's outputs, and each
    part is captured as a graph of its own, in one memory pool, so a part
    reads the one before's static outputs in place; a replay of a part
    opens ``mssvt.<span>`` where ``span`` is set. The last part returns a
    list of voxels, as ``eager(sp)`` does.

    A new key drops the last one's graphs, runs ``eager`` on a side stream
    (the call's answer; every lazy cache fills), then captures the parts
    there from static copies of the inputs (``mssvt.<name>_capture``); a
    capture that raises leaves the key eager (``mssvt.<name>_eager``),
    with one warning. A later call copies its inputs into the static ones
    and replays the parts (``mssvt.<name>``). The launch counters count
    the first call's launches; a replay adds those its capture counted."""

    def __init__(self, name: str, what: str):
        self.name, self.what = name, what
        self.key = None
        self.captured = None  # the key's _Graphs; None: the key runs eagerly
        self.warned = False

    def clear(self):
        """Drops the graphs (say, before code the forward calls is
        patched)."""
        self.key = self.captured = None

    def __getstate__(self):
        # a copy of the module (deepcopy, pickle) starts with no graphs:
        # they read and write this module's tensors, not the copy's
        return {"name": self.name, "what": self.what}

    def __setstate__(self, state):
        self.__init__(state["name"], state["what"])

    def run(self, module, sp, parts, eager, keep):
        """(``keep`` of the forward's voxels, statics): after a replay,
        clones of the voxels ``keep`` picks (the next replay overwrites the
        static ones) and each part's static outputs, valid until the next
        replay; where the call ran eagerly, ``keep`` of ``eager(sp)`` and
        None."""
        key = self._key(module, sp)
        if key != self.key:
            return keep(self._setup(module, sp, key, parts, eager)), None
        g = self.captured
        if g is None:
            with tracing.span(self.name + "_eager"):
                return keep(eager(sp)), None
        with tracing.span(self.name):
            for dst, src in zip(g.inputs, (sp.features, sp.coords, sp.valid)):
                dst.copy_(src)
            for span, graph in g.graphs:
                with (tracing.span(span) if span else
                      contextlib.nullcontext()):
                    graph.replay()
            out = clone_voxels(keep(g.outputs[-1]))
        kernels.add_launch_counts(g.launches)
        return out, g.outputs

    @staticmethod
    def _key(module, sp):
        tensors = (sp.features, sp.coords, sp.valid)
        return (tuple((t.shape, t.dtype, t.device) for t in tensors),
                sp.batch_size, sp.spatial_shape, sp.voxel_size,
                sp.point_cloud_range,
                tuple(t.data_ptr() for t in itertools.chain(
                    module.parameters(), module.buffers())))

    def _setup(self, module, sp, key, parts, eager):
        self.clear()  # the last key's graphs and their memory go first
        dev = sp.features.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out = eager(sp)
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.key = key
        try:
            self.captured = self._capture(sp, parts, stream)
        except RuntimeError as err:
            if not self.warned:
                self.warned = True
                warnings.warn(f"{self.what}: CUDA graph capture failed, "
                              f"this input runs eagerly: {err}",
                              RuntimeWarning, stacklevel=3)
        return out

    def _capture(self, sp, parts, stream) -> _Graphs:
        # the static inputs take in-place copies in and out of inference mode
        with torch.inference_mode(False):
            inputs = tuple(torch.empty_like(t)
                           for t in (sp.features, sp.coords, sp.valid))
        for dst, src in zip(inputs, (sp.features, sp.coords, sp.valid)):
            dst.copy_(src)
        static = replace(sp, features=inputs[0], coords=inputs[1],
                         valid=inputs[2])
        mark = kernels.launch_counts()
        graphs, outputs, pool, prev = [], [], None, None
        try:
            with tracing.span(self.name + "_capture"):
                for span, fn in parts:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool, stream=stream,
                                          capture_error_mode="thread_local"):
                        prev = fn(static, prev)
                    pool = graph.pool()
                    graphs.append((span, graph))
                    outputs.append(prev)
        finally:  # a capture launches nothing: take its counts back
            launches = {n: v - mark[n]
                        for n, v in kernels.launch_counts().items()}
            kernels.add_launch_counts({n: -v for n, v in launches.items()})
        return _Graphs(graphs, inputs, outputs, launches)


def clone_voxels(voxels):
    """The voxels with cloned tensors, their sorted-key index too (a tensor
    that several share, cloned once)."""
    memo = {}

    def clone(t):
        if id(t) not in memo:
            memo[id(t)] = t.clone()
        return memo[id(t)]

    return [replace(s, features=clone(s.features), coords=clone(s.coords),
                    valid=clone(s.valid),
                    index=None if s.index is None else VoxelIndex(
                        clone(s.index.sorted_keys),
                        clone(s.index.sorted_rows)))
            for s in voxels]


def run_forward_hooks(calls):
    """Each ``(module, args, output)`` call's forward hooks as its eager
    call runs them (plain hooks only: :func:`graphable` sends any other to
    the eager forward)."""
    for module, args, out in calls:
        for hook in module._forward_hooks.values():
            if hook(module, args, out) is not None:
                raise RuntimeError(
                    f"a forward hook on the graphed {type(module).__name__} "
                    "may not replace the module's output")
