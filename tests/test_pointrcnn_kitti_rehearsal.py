"""``benchmark/run.py --workload pointrcnn-kitti-infer-b2 --rehearse-cpu``:
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

CELL = "pointrcnn-kitti-infer-b2"

# each fault, planted before ``run.main`` in the run's own process
OTHER_PICKS = """
from mssvt_tpu_torch.models.backbones_3d import pointnet2_backbone as pb
orig = pb.farthest_point_sample
def moved(xyz, npoint):  # every pick one row on
    return (orig(xyz, npoint) + 1) % xyz.shape[1]
pb.farthest_point_sample = moved
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
OTHER_MEMBERS = """
from mssvt_tpu_torch.models.backbones_3d import pointnet2_backbone as pb
orig = pb.ball_query
def wider(radius, nsample, xyz, new_xyz, xyz_valid=None):  # radii x 1.5
    return orig(radius * 1.5, nsample, xyz, new_xyz, xyz_valid)
pb.ball_query = wider
"""
ROIS_SHIFTED = """
from mssvt_tpu_torch.models.detectors import point_rcnn
orig = point_rcnn.proposal_layer
def moved(*a, **k):  # every RoI 0.2 m along x
    rois, scores, labels, valid = orig(*a, **k)
    rois = rois.clone()
    rois[..., 0] += 0.2 * valid
    return rois, scores, labels, valid
point_rcnn.proposal_layer = moved
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
    (OTHER_PICKS, "backbone_rel", float("inf")),    # fps_gap not 0
    (OTHER_MEMBERS, "backbone_rel", float("inf")),  # query_gap not 0
    (SHIFTED, "det_gap", 0.2),
    (HALF_BATCH, "count_gap", 1.0),
    (ROIS_SHIFTED, "det_gap", None)],
    ids=["other_picks", "other_members", "shifted", "half_batch",
         "rois_shifted"])
def test_a_fault_in_the_timed_path_is_not_correct(fault, number, value):
    """FPS picks other than the plain loop's, at every level of the backbone
    and the RoI head, read as picks that differ (``backbone_rel``
    infinite); ball queries of other radii as members that differ (the
    same); boxes moved 0.2 m as a ``det_gap`` of 0.2; half the frames
    unanswered as a ``count_gap`` of 1. The proposals are judged apart
    from the second stage, which takes the program's RoIs: every RoI moved
    0.2 m puts ``det_gap`` over its limit."""
    res = result(plant=fault)
    assert res["correct"] is False, res["checks"]
    got = res["checks"][number]
    if value is None:
        assert got["value"] > got["limit"], res["checks"]
    else:  # +0.2 m in f32 on boxes up to ~13 m out: a few ulps of 1e-6
        assert got["value"] == pytest.approx(value, abs=1e-5)
