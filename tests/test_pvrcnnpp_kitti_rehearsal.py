"""``benchmark/run.py --workload pvrcnnpp-kitti-infer-b2 --rehearse-cpu``:
the whole harness on the CPU at the rehearsal's size, each run in a
process of its own (the harness refuses to report from a process that has
loaded JAX, as this suite's does). The unbroken program is ``correct``;
the control (the reference one precision below, fp8 products, in the
program's place) and faults planted in the timed path are not."""

import json
import subprocess
import sys
import textwrap

import pytest

from benchmark.harness import spec

CELL = "pvrcnnpp-kitti-infer-b2"

# each fault, planted before ``run.main`` in the run's own process
OTHER_KEYPOINTS = """
from mssvt_tpu_torch.models.backbones_3d import pfe
orig = pfe.sector_fps
def moved(xyz, valid, npoint, sectors):  # every pick one row on
    return (orig(xyz, valid, npoint, sectors) + 1) % xyz.shape[1]
pfe.sector_fps = moved
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
PROPOSAL_NMS = """
from mssvt_tpu_torch.models.roi_heads import roi_head_template as rt
orig = rt.nms_kwargs
def stricter(roi_cfg, train):  # the proposals suppressed at IoU 0.1, not 0.7
    return dict(orig(roi_cfg, train), nms_thresh=0.1)
rt.nms_kwargs = stricter
"""
ROIS_SHIFTED = """
from mssvt_tpu_torch.models.roi_heads import roi_head_template as rt
orig = rt.propose
def moved(dense_head, preds, roi_cfg, train):  # every RoI 0.2 m along x
    rois, scores, labels, valid = orig(dense_head, preds, roi_cfg, train)
    rois = rois.clone()
    rois[..., 0] += 0.2 * valid
    return rois, scores, labels, valid
rt.propose = moved
"""


def result(*extra, plant="", seed=2**31 + 9):
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


@pytest.mark.parametrize("fault,number,value", [
    (OTHER_KEYPOINTS, "backbone_rel", float("inf")),  # kp_gap not 0
    (SHIFTED, "det_gap", 0.2),
    (HALF_BATCH, "count_gap", 1.0),
    (PROPOSAL_NMS, "det_gap", None),
    (ROIS_SHIFTED, "det_gap", None)],
    ids=["other_keypoints", "shifted", "half_batch", "proposal_nms",
         "rois_shifted"])
def test_a_fault_in_the_timed_path_is_not_correct(fault, number, value):
    """Keypoints other than the sector FPS's picks read as picks that
    differ (``backbone_rel`` infinite, as sites that differ); boxes moved
    0.2 m as a ``det_gap`` of 0.2; half the frames unanswered as a
    ``count_gap`` of 1. The proposals are judged apart from the second
    stage, which takes the program's RoIs: a stricter proposal NMS, or
    every RoI moved 0.2 m, puts ``det_gap`` over its limit."""
    res = result(plant=fault)
    assert res["correct"] is False, res["checks"]
    got = res["checks"][number]
    if value is None:
        assert got["value"] > got["limit"], res["checks"]
    else:
        assert got["value"] == pytest.approx(value)
