"""``benchmark/run.py --workload second-kitti-infer-b4 --rehearse-cpu``: the
whole harness on the CPU at the rehearsal's size, each run in a process of
its own (the harness refuses to report from a process that has loaded
JAX, as this suite's does). The unbroken program is ``correct``; the
control (the reference one precision below, fp8 products, in the
program's place) and faults planted in the timed path are not."""

import json
import subprocess
import sys
import textwrap

import pytest

from benchmark.harness import spec

CELL = "second-kitti-infer-b4"

# each fault, planted before ``run.main`` in the run's own process
HALF_BATCH = """
from mssvt_tpu_torch.runtime import eval_utils
orig = eval_utils.eval_step
def broken(model, batch):  # the second half of the frames gets no answer
    boxes, scores, labels, mask = (t.clone() for t in orig(model, batch))
    half = mask.shape[0] // 2
    mask[half:] = False
    boxes[half:] = 0
    scores[half:] = 0
    return boxes, scores, labels, mask
eval_utils.eval_step = broken
"""
SHIFTED = """
from mssvt_tpu_torch.runtime import eval_utils
orig = eval_utils.eval_step
def broken(model, batch):  # every kept box moved 0.2 m along x
    boxes, scores, labels, mask = (t.clone() for t in orig(model, batch))
    boxes[..., 0] += 0.2 * mask
    return boxes, scores, labels, mask
eval_utils.eval_step = broken
"""
CAPPED = """
from mssvt_tpu_torch.models.backbones_3d import spconv_backbone
orig = spconv_backbone.downsample_output_sites
def capped(coords, valid, shape, kernel, stride, padding, max_out):
    # a capacity that binds: an eighth of the strided stages' rows
    return orig(coords, valid, shape, kernel, stride, padding, max_out // 8)
spconv_backbone.downsample_output_sites = capped
"""


def result(*extra, plant="", seed=2**31 + 5):
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(spec.ROOT)!r})
        from benchmark import run
        {textwrap.indent(plant, ' ' * 8).strip()}
        sys.exit(run.main({["--workload", CELL, "--seed", str(seed),
                            "--seconds", "0.5", "--trace", "0",
                            "--rehearse-cpu", *extra]!r}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"{CELL} seed {seed} {' '.join(extra)}: " + ", ".join(
        f"{k} {c['value']:.4g}" for k, c in res["checks"].items()))
    return res


def test_the_unbroken_rehearsal_is_correct():
    res = result()
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["infer_frames_per_s"]["value"] > 0


def test_the_fp8_control_is_not_correct():
    res = result("--control")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", [HALF_BATCH, SHIFTED],
                         ids=["half_batch", "shifted"])
def test_a_fault_in_the_timed_path_is_not_correct(fault):
    res = result(plant=fault)
    assert res["correct"] is False, res["checks"]


def test_a_capacity_cut_is_seen():
    """The program's strided stages keep fewer sites than spconv's rule
    gives: the check fails on the sites (``backbone_rel`` infinite)."""
    res = result(plant=CAPPED)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["backbone_rel"]["value"] == float("inf")
