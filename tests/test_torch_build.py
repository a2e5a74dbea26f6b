"""The CUDA library's build at first use (``kernels/_lib.py``) under
concurrent first calls, as the ranks of a data-parallel run make them. No
nvcc is needed: ``NVCC`` points at a fake compiler that logs each output it
writes, sleeps, and writes it."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

FAKE_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
log = os.environ["FAKE_NVCC_LOG"]
with open(log, "a") as f:
    f.write(f"start {{os.getpid()}} {{time.time()!r}} {{out}}\\n")
if os.environ.get("FAKE_NVCC_FAIL") and "-c" in args:
    print("fake nvcc: error")
    sys.exit(1)
time.sleep(0.4)
with open(out, "w") as f:
    f.write("fake " + " ".join(args))
with open(log, "a") as f:
    f.write(f"end {{os.getpid()}} {{time.time()!r}} {{out}}\\n")
"""

CHILD = """
import sys, time
from pathlib import Path
sys.path.insert(0, {root!r})
from mssvt_tpu_torch.kernels import _lib
_lib.BUILD_DIR = Path({build!r})
print("ready", flush=True)
while not Path({go!r}).exists():
    time.sleep(0.01)
print(_lib.build(), flush=True)
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("NVCC", str(nvcc))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    return log


def _writes(log):
    """{output path: [(pid, start, end)]} from the fake compiler's log."""
    starts, spans = {}, {}
    for line in log.read_text().splitlines():
        kind, pid, t, out = line.split(" ", 3)
        if kind == "start":
            starts[(pid, out)] = float(t)
        else:
            spans.setdefault(out, []).append(
                (pid, starts[(pid, out)], float(t)))
    return spans


def test_concurrent_first_builds_share_one_library(fake_nvcc, tmp_path):
    """Two processes call ``build()`` at the same moment on an empty
    ``BUILD_DIR``: both return the same library path, one process compiles
    (one object a source, each written once), the other waits for the
    lock and finds the library, and no private build directory is left."""
    build, go = tmp_path / "kernels", tmp_path / "go"
    code = CHILD.format(root=str(ROOT), build=str(build), go=str(go))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    for p in procs:
        assert p.stdout.readline().strip() == "ready"
    go.touch()
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert outs[0] == outs[1]
    so = Path(outs[0])
    assert so.parent == build and so.exists()
    assert so.read_text().startswith("fake ") and "-shared" in so.read_text()
    spans = _writes(fake_nvcc)
    objs = {o: s for o, s in spans.items() if o.endswith(".o")}
    n_src = len(list((ROOT / "mssvt_tpu_torch" / "csrc").glob("*.cu")))
    assert len(objs) == n_src
    assert all(len(s) == 1 for s in spans.values()), spans
    assert len({Path(o).parent for o in objs}) == 1  # one private dir
    assert (build / "build.log").exists()
    assert sorted(p.name for p in build.iterdir()) == sorted(
        [so.name, "build.log", "build.lock"])


def test_failed_build_raises_and_releases_the_lock(fake_nvcc, tmp_path,
                                                  monkeypatch):
    """A compiler error raises with the compiler's output and leaves no
    library; the next call builds."""
    from mssvt_tpu_torch.kernels import _lib

    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="fake nvcc: error"):
        _lib.build()
    assert not list(_lib.BUILD_DIR.glob("*.so"))
    monkeypatch.delenv("FAKE_NVCC_FAIL")
    t0 = time.time()
    so = _lib.build()
    assert so.exists() and time.time() - t0 < 60
    assert not [p for p in _lib.BUILD_DIR.iterdir() if p.is_dir()]
    os.remove(so)
