"""Data parallelism on ``torch.distributed`` (torch counterpart of
``mssvt_tpu/parallel/mesh.py``).

The reference's only parallelism is DDP over NCCL (ref: tools/train.py:
142-144). The JAX package runs one sharded step over a device mesh and
``pmean``s gradients, loss and BatchNorm statistics over its data axis. The
port runs one process a rank, as the reference does:

- :func:`init_distributed` joins the process group for a launcher
  (``none``, ``pytorch`` under ``torchrun``, ``slurm``) and sets the rank's
  device. The backend follows the device: NCCL for CUDA, gloo for the CPU,
  unless the caller names one;
- :func:`wrap_ddp` wraps the model in ``DistributedDataParallel``, which
  averages the gradients over the ranks during the backward;
- :func:`launch_local` starts N processes on this host, the counterpart of
  the JAX entry points driving N local devices from one process
  (``--num_devices N`` under ``--launcher none``).

SyncBN lives in ``models/model_utils/syncbn.py``; the loss, ``tb_dict`` and
timing averages in ``runtime/train_utils.py``.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import shutil
import subprocess
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

LAUNCHERS = ("none", "pytorch", "slurm")
# the rendezvous a process started by launch_local joins (file://...)
INIT_ENV = "MSSVT_DIST_INIT"


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_world():
    if not initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def init_distributed(launcher="none", device="cuda", backend=None,
                     device_index=None, tcp_port=18888, logger=None):
    """Join the process group of ``launcher`` and set this rank's device.

    - ``none``: one process, no group; returns (0, 1).
    - ``pytorch``: ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from the
      environment ``torchrun`` sets, rendezvous ``env://`` (pcdet's
      ``init_dist_pytorch``), or the file rendezvous that ``launch_local``
      names in ``MSSVT_DIST_INIT``.
    - ``slurm``: rank and world from ``SLURM_PROCID`` / ``SLURM_NTASKS``, the
      address from the first host of ``SLURM_NODELIST`` (``scontrol show
      hostname``), port ``tcp_port`` unless ``MASTER_PORT`` is set (pcdet's
      ``init_dist_slurm``).

    ``device`` is ``cuda`` or ``cpu``; on ``cuda`` the rank takes card
    ``device_index`` (default its local rank) and raises when there is no
    such card: NCCL runs one rank a card. ``backend`` defaults to NCCL on
    ``cuda`` and gloo on the CPU. Returns ``(rank, world_size)``."""
    if launcher not in LAUNCHERS:
        raise ValueError(f"launcher {launcher!r}: expected one of {LAUNCHERS}")
    device = torch.device(device).type
    if launcher == "none":
        return 0, 1
    if launcher == "slurm":
        proc_id = int(os.environ["SLURM_PROCID"])
        ntasks = int(os.environ["SLURM_NTASKS"])
        addr = subprocess.getoutput(
            f"scontrol show hostname {os.environ['SLURM_NODELIST']} "
            "| head -n1").strip()
        os.environ.setdefault("MASTER_PORT", str(tcp_port))
        os.environ["MASTER_ADDR"] = addr
        os.environ["WORLD_SIZE"] = str(ntasks)
        os.environ["RANK"] = str(proc_id)
        per_node = torch.cuda.device_count() if device == "cuda" else 1
        os.environ["LOCAL_RANK"] = str(proc_id % max(per_node, 1))
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device == "cuda":
        index = local_rank if device_index is None else int(device_index)
        if not torch.cuda.is_available() or index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: card {index} is not available "
                f"({torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                " visible); one rank a card, or pass --device cpu")
        torch.cuda.set_device(index)
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    dist.init_process_group(backend,
                            init_method=os.environ.get(INIT_ENV, "env://"),
                            rank=rank, world_size=world,
                            device_id=local_device(device)
                            if device == "cuda" else None)
    if logger:
        logger.info(f"distributed: rank {rank}/{world}, backend {backend}, "
                    f"device {local_device(device)}")
    return rank, world


def local_device(device_type) -> torch.device:
    """This rank's device: the current card for ``cuda``."""
    if torch.device(device_type).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shutdown():
    """Leave the process group (after a barrier), if one was joined."""
    if initialized():
        dist.barrier()
        dist.destroy_process_group()


def barrier():
    if initialized():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank; ``obj`` alone in one
    process."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def wrap_ddp(model):
    """``DistributedDataParallel`` around ``model`` (ref: train.py:142-144).

    Buffers are not broadcast from rank 0 at each forward
    (``broadcast_buffers=False``): the only buffers are BatchNorm's running
    statistics, which SyncBN (``syncbn.py``) already makes equal on every
    rank, and ranks start from equal weights (the same seed, or the same
    checkpoint, which DDP's constructor also broadcasts). Every parameter
    gets a gradient in a training step, so ``find_unused_parameters`` stays
    off."""
    from torch.nn.parallel import DistributedDataParallel

    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        broadcast_buffers=False)


def unwrap(model):
    """The module inside a ``DistributedDataParallel``, else ``model``."""
    return getattr(model, "module", model)


def _child(target, rank, world, init, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    os.environ[INIT_ENV] = init
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        # pickled here by value: a tensor put on the queue as it is would
        # travel as a handle to this process's memory, gone once it exits
        results.put((rank, True, pickle.dumps(target())))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def launch_local(target, nprocs: int, timeout_s: float = 3600.0):
    """Run ``target()`` (a picklable callable, e.g. a ``functools.partial``
    of a module-level function) in ``nprocs`` fresh processes with
    ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` set and a file rendezvous in a
    private temporary directory, so that ``init_distributed("pytorch", ...)``
    inside joins them; returns the ranks' return values in rank order. A
    rank that raises or dies stops the others and raises here."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mssvt_rdzv_")
    results = ctx.SimpleQueue()
    procs = [ctx.Process(target=_child,
                         args=(target, r, nprocs, f"file://{tmp}/rdzv", results))
             for r in range(nprocs)]
    out, errors = {}, []
    try:
        for p in procs:
            p.start()
        deadline = time.time() + timeout_s
        while len(out) + len(errors) < nprocs:
            while not results.empty():
                rank, ok, value = results.get()
                if ok:
                    out[rank] = pickle.loads(value)
                else:
                    errors.append(f"rank {rank}:\n{value}")
            if errors:
                break
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in out]
            if dead and results.empty():
                errors.append(f"ranks {dead} exited with "
                              f"{[procs[r].exitcode for r in dead]}")
                break
            if time.time() > deadline:
                errors.append(f"timed out after {timeout_s} s")
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if errors and p.is_alive():
                p.terminate()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("launch_local: " + "\n".join(errors))
    return [out[r] for r in range(nprocs)]


def run_script(path, fn_name, *args):
    """Load the script at ``path`` and call its ``fn_name(*args)`` (the
    target :func:`launch_local` gives an entry point's ranks)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"mssvt_rank_{os.getpid()}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, fn_name)(*args)

