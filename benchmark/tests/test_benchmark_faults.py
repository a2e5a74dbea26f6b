"""The correctness check fails what it must: the control (the reference
one precision below the configuration's, in the program's place) and each
fault an inference cell can have, planted in the program's timed path
(its eval request), on a whole run of the harness with the cell's own
limits: at the CPU rehearsal's size here, at the cell's own size on the
card (``cuda``)."""

import json

import pytest
import torch

from benchmark import run


def result(capsys, cell, *extra, seed=7):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", "0", *extra])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with capsys.disabled():  # the readings, for the record
        print(f"\n{cell} seed {seed} {' '.join(extra)}: "
              + ", ".join(f"{k} {c['value']:.4g}"
                          for k, c in res["checks"].items()))
    return res


def failed(res):
    return [k for k, c in res["checks"].items() if not c["value"] <= c["limit"]]


def plant(monkeypatch, fault):
    """``fault`` in the eval request's output, or, for a fault of the NMS
    (``fault.nms``), in the detector's NMS."""
    if getattr(fault, "nms", False):
        from mssvt_tpu_torch.models.dense_heads import center_head

        monkeypatch.setattr(center_head, "nms_bev",
                            fault(center_head.nms_bev))
        return
    from mssvt_tpu_torch.runtime import eval_utils

    orig = eval_utils.eval_step

    def broken(model, batch):
        return fault(*(t.clone() for t in orig(model, batch)))

    monkeypatch.setattr(eval_utils, "eval_step", broken)


def half_batch(boxes, scores, labels, mask):
    """The second half of the frames gets no answer."""
    half = mask.shape[0] // 2
    mask[half:] = False
    boxes[half:] = 0
    scores[half:] = 0
    return boxes, scores, labels, mask


def altered(boxes, scores, labels, mask):
    """Each frame's first detection is altered where it is produced."""
    scores[:, 0] += 0.5
    return boxes, scores, labels, mask


def swapped(nms):
    """The NMS keeps as many boxes as it should, but the lower-ranked half
    of them (at least one) are swapped for the best-scoring candidates it
    did not keep."""
    def broken(boxes, scores, valid, thresh, pre_max, post_max):
        sel, num = nms(boxes, scores, valid, thresh, pre_max, post_max)
        sel = sel.clone()
        s = torch.where(valid, scores, float("-inf"))
        order = torch.argsort(s, dim=1, descending=True, stable=True)
        for b in range(sel.shape[0]):
            n = int(num[b])
            kept = torch.zeros(boxes.shape[1], dtype=torch.bool,
                               device=boxes.device)
            kept[sel[b, :n].long()] = True
            others = order[b][~kept[order[b]]]
            m = min(n - n // 2, len(others))
            sel[b, n - m:n] = others[:m].to(sel.dtype)
        return sel, num
    return broken


swapped.nms = True
FAULTS = [half_batch, altered, swapped]


@pytest.mark.parametrize("cell", ["mssvt-waymo-infer-b2"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(capsys, monkeypatch, cell,
                                                  fault):
    plant(monkeypatch, fault)
    res = result(capsys, cell, "--rehearse-cpu")
    assert res["correct"] is False, res["checks"]
    assert failed(res)


def test_an_unbroken_rehearsal_is_correct(capsys):
    res = result(capsys, "mssvt-waymo-infer-b2", "--rehearse-cpu")
    assert res["correct"] is True, res["checks"]


def test_the_fp8_control_is_not_correct(capsys):
    res = result(capsys, "mssvt-waymo-infer-b2", "--rehearse-cpu",
                 "--control")
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("cell", ["mssvt-waymo-infer-b2"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_at_the_cells_size_is_not_correct(card, capsys, monkeypatch,
                                                  cell, fault, seed):
    plant(monkeypatch, fault)
    res = result(capsys, cell, seed=seed)
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("cell", ["mssvt-waymo-infer-b2"])
def test_the_control_at_the_cells_size_is_not_correct(card, capsys, cell,
                                                      seed):
    res = result(capsys, cell, "--control", seed=seed)
    assert res["correct"] is False, res["checks"]
