"""The plain reference agrees with the port on the CPU at the CPU
rehearsal's size of ``mssvt-waymo``, in float32, on the benchmark's
weights."""

import copy

import torch

from benchmark.harness import compare, program, spec, weights


def test_reference_matches_the_port():
    name = "mssvt-waymo"
    config = copy.deepcopy(spec.load_json(spec.BENCH / "rehearsal" /
                                          f"{name}.json"))
    config["MODEL"].pop("DTYPE", None)  # float32 on both sides
    ref = spec.load_module(spec.BENCH / "reference" / f"{name}.py")
    gen = spec.load_module(spec.BENCH / "traffic" / "waymo_scene.py")
    cpu = torch.device("cpu")
    batch = 2
    host, _ = gen.make(config["traffic"]["params"], config, batch, 11)
    batches = [program.to_device(b, cpu) for b in host]
    ref_model = ref.build(config, batch, cpu)
    made = weights.make(ref_model, 11, cpu, batches[0], ref.forward)
    model = program.build(config, batch, cpu, made)
    for b in batches:
        got = {}
        hooks = [model.backbone_3d.register_forward_hook(
                     lambda m, a, o: got.__setitem__("bb", o)),
                 model.dense_head.register_forward_hook(
                     lambda m, a, o: got.__setitem__("head", o))]
        dets = program.request(model, b)
        for h in hooks:
            h.remove()
        want = {}
        hooks = [ref_model.backbone_3d.register_forward_hook(
                     lambda m, a, o: want.__setitem__("bb", o)),
                 ref_model.dense_head.register_forward_hook(
                     lambda m, a, o: want.__setitem__("head", o))]
        out = ref.forward(ref_model, b)
        for h in hooks:
            h.remove()
        bb = lambda sp: (sp.features, sp.coords, sp.valid)  # noqa: E731
        assert compare.backbone_rel(bb(got["bb"]), bb(want["bb"])) < 1e-5
        assert compare.head_rel(got["head"], want["head"]) < 1e-5
        kept = (out["final_boxes"], out["final_scores"],
                out["final_labels"], out["final_mask"])
        assert compare.det_gap(
            dets, kept, ref.candidates(ref_model, want["head"])) < 1e-4
        assert compare.count_gap(dets[3], out["final_mask"]) == 0.0
        assert int(dets[3].sum()) > 0
