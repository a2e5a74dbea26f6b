"""Build-at-first-use loader for the port's CUDA kernels.

Every ``mssvt_tpu_torch/csrc/*.cu`` is compiled for ``sm_90a`` with one
``nvcc -c`` per source, all started together, and linked into one shared
library with a plain C interface under ``build/kernels/`` at the repo root.
The library is loaded with ``ctypes``; a content hash of the sources names
it, so an edited source triggers a rebuild and an unchanged tree reuses the
previous build. Nothing here runs at import time: the first CUDA tensor that
reaches a kernel wrapper calls :func:`lib`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
BUILD_SECONDS = None

VP = ctypes.c_void_p
CI = ctypes.c_int
CF = ctypes.c_float
CL = ctypes.c_longlong

# C signatures: every entry returns a cudaError_t (0 = launched)
_SIGNATURES = {
    "mssvt_fill": [VP, CI, CI, CI, VP, CI, CI, CI, VP, VP, VP, VP, VP, VP],
    "mssvt_fill_plan": [CI, CI, CI, VP],
    "mssvt_fps": [VP, CI, CI, CI, CI, CI, VP, VP, VP, VP],
    "mssvt_fps_picks_warp": [VP, VP, VP, CI, CI, CI, VP, VP],
    "mssvt_fps_picks_block": [VP, VP, VP, CI, CI, CI, VP, VP],
    "mssvt_fps_picks_masked": [VP, VP, VP, VP, CI, CI, CI, CI, VP, VP],
    "mssvt_attention": [VP, VP, CF, CI, VP],
    "mssvt_attention_bwd": [VP, VP, CF, CI, VP],
    "mssvt_attention_qk": [VP, VP, CF, CI, VP],
    "mssvt_attention_qk_bwd": [VP, VP, CF, CI, VP],
    "mssvt_attention_plan": [VP, CI, VP],
    "mssvt_attention_qk_plan": [VP, CI, VP],
    "mssvt_attention_bwd_plan": [VP, CI, VP],
    "mssvt_attention_qk_bwd_plan": [VP, CI, VP],
    "mssvt_ffn": [VP, VP, VP, VP, VP, VP, VP, VP, CI, CI, CI, CF, CI, VP],
    "mssvt_ffn_plan": [CI, CI, VP],
    "mssvt_nms_greedy": [VP, VP, VP, CI, CI, CI, VP, VP, VP, VP],
    "mssvt_nms_greedy_packed": [VP, VP, VP, CI, CI, CI, VP, VP, VP],
    "mssvt_nms_iou_mask": [VP, CI, CI, CI, CF, VP, VP],
    "mssvt_ball_query": [VP, CL, CL, CL, VP, CL, CL, CL, VP, CL, CL, CI, CI,
                         CI, CI, CF, VP, VP, VP],
}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")) + sorted(CSRC.glob("*.h")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library.

    Safe under concurrent first use (the ranks of a data-parallel run, test
    workers): the build holds an exclusive ``flock`` on ``BUILD_DIR/
    build.lock`` and looks for the library again once it has the lock, so
    one process compiles and the others load its result. The objects go to
    a directory private to the process, and the library and ``build.log``
    are published by atomic renames. A failed build raises (and releases
    the lock)."""
    so = BUILD_DIR / f"libmssvt_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
            try:
                _compile(so, work)
            finally:
                shutil.rmtree(work, ignore_errors=True)
    return so


def _compile(so: Path, work: Path):
    """One nvcc per source into ``work``, linked into ``so``."""
    global BUILD_SECONDS
    t0 = time.time()
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    objs, log, failed = [], [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out.decode(errors='replace')}")
        if p.returncode != 0:
            failed.append(log[-1])
        objs.append(str(obj))
    (work / "build.log").write_text("\n".join(log))
    (work / "build.log").replace(BUILD_DIR / "build.log")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = work / so.name
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(tmp), *objs], check=True)
    tmp.replace(so)
    BUILD_SECONDS = time.time() - t0


def lib():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = CI
        _LIB = handle
    return _LIB


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, dtype=None, shape=None, device=None):
    """Raise unless ``t`` is contiguous with the given dtype/shape/device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t


def kernel_plan(entry: str, dims, bf16: bool):
    """(shared-memory bytes of one CTA, CTAs an SM holds, registers a
    thread) of a per-window attention kernel at the layout ``dims``, from the
    CUDA occupancy API and the kernel's attributes."""
    out = (CI * 3)()
    check(getattr(lib(), entry)((CI * len(dims))(*dims), int(bf16), out), entry)
    return out[0], out[1], out[2]


def transposed(weights):
    """Contiguous transposes ([output][input] channel) of (D, D) projection
    weights: the tensor-core paths of the attention kernels read a weight
    fragment as two 4-byte loads from them. The transposes are slices of
    one buffer, made by two launches whatever the number of weights."""
    return list(torch.stack(list(weights)).transpose(1, 2).contiguous())


def ptr_array(tensors):
    """Host array of device pointers (``const void* const*``) for ctypes."""
    arr = (VP * len(tensors))(*[ptr(t) for t in tensors])
    return arr
