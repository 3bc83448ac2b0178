"""The plain reference against the program's f32 paths at 96 x 128 on the
CPU: the unfused and the folded forward, serving's post-processing, and
the followed training steps (transform, losses, backward, Adam).  Also: the
reference imports nothing of the program."""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import catalog, program, scenes
from benchmark.harness.cli import log
from benchmark.harness.weights import draw
from benchmark.reference import model as ref_model
from benchmark.reference import serve as ref_serve
from benchmark.tests import small

CONFIGS = [c["name"] for c in catalog.load_bench()["configs"]]


def _config(name):
    cell = next(w for w in catalog.load_bench()["workloads"] if w["config"] == name)
    return small.small_config(catalog.find_cell(cell["name"]).config)


def test_reference_imports_nothing_of_the_program():
    """Every file under reference/, the backbones' included."""
    paths = list((catalog.BENCH_DIR / "reference").rglob("*.py"))
    assert catalog.BENCH_DIR / "reference" / "backbones" / "mobilenetv2.py" in paths
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any(n.split(".")[0].startswith("ssdseglib") for n in names), path


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_equals_the_programs_f32_model(name):
    small.cpu()
    config = _config(name)
    weights = draw(config["model"], 7, "cpu")
    build = program.builder(config, program.anchors(config))
    net = program.network(config, build, weights, "cpu").eval()
    images = torch.from_numpy(np.stack([scenes.scene(i, 7, (96, 128))[0] for i in range(2)]))
    with torch.no_grad():
        out = net(images.float())
        mask, labels, boxes = ref_model.build(config["model"], weights, "cpu")(images.float())
    assert (out["output-mask"] - mask).abs().max() < 1e-5
    assert (out["output-labels"] - labels).abs().max() < 1e-5
    assert (out["output-boxes"] - boxes).abs().max() <= 1e-4 * boxes.abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_served_outputs_equal_the_references_in_f32(name):
    small.cpu()
    config = _config(name)
    config["serve"].update(compute_dtype="float32", mask_output="float32")
    weights = draw(config["model"], 11, "cpu")
    anchor_set = program.anchors(config)
    build = program.builder(config, anchor_set)
    inf = build.get_model_for_inference(program.network(config, build, weights, "cpu"),
                                        device="cpu", **program.nms_arguments(config),
                                        **config["serve"])
    images = np.stack([scenes.scene(i, 11, (96, 128))[0] for i in range(2)])
    mask, det = inf(images)
    _, centroids = ref_serve.anchors(config["anchors"], config["encoding"]["image_shape"])
    assert np.allclose(centroids, anchor_set.centroids)
    with torch.no_grad():
        ref = ref_model.build(config["model"], weights, "cpu")(torch.from_numpy(images).float())
        numbers = ref_serve.judge_batch(mask, det, *ref, torch.from_numpy(centroids),
                                        config["encoding"]["standard_deviations"], config["nms"])
        ours = ref_serve.serve_reference(*ref, torch.from_numpy(centroids),
                                         config["encoding"]["standard_deviations"], config["nms"])
    assert numbers["mask_max_abs"] < 1e-5 and numbers["det_box_rel"] < 1e-3
    assert numbers["det_gap"] < 1e-4 and numbers["rows"] > 0
    assert torch.equal(det[..., 0], ours[..., 0])
    assert (det - ours).abs().max() <= 1e-3 * max(1.0, float(ours.abs().max()))


NMS = {"score_threshold": 0.725, "iou_threshold": 0.025, "max_boxes_per_class": 4,
       "max_boxes_per_sample": 10}


@pytest.mark.parametrize("offset,counted", [(98.0, False), (110.0, True)])
def test_a_candidate_touching_a_served_box_is_not_a_gap(offset, counted):
    """Boxes A (0.95, served), B (0.9, not served) and C (0.8, served, far
    away).  B overlapping A by a sliver (IoU 0.0101, under the threshold)
    may be suppressed by a bf16 program: no gap.  B clear of A: its score
    above C's and above the threshold are gaps."""
    boxes = torch.tensor([[0.0, 0.0, 100.0, 100.0], [0.0, offset, 100.0, offset + 100.0],
                          [300.0, 300.0, 400.0, 400.0]])
    scores = torch.tensor([[0.95], [0.9], [0.8]])
    rows = torch.zeros(10, 6)
    for i, k in enumerate((0, 2)):
        y0, x0, y1, x1 = boxes[k].tolist()
        rows[i] = torch.tensor([0.0, float(scores[k, 0]), x0, y0, x1, y1])
    gap, box_px, _, n = ref_serve.judge_detections(rows, scores, boxes, NMS)
    assert n == 2 and box_px == 0.0
    assert gap == (pytest.approx(0.9 - 0.725) if counted else 0.0)


@pytest.mark.parametrize("prefix", ["", "window_"])
def test_followed_steps_equal_the_programs_f32_steps(tmp_path, prefix):
    """Both followed runs, the set-up's from the seeded weights and the
    window's from the program's state at a later epoch."""
    cell = catalog.find_cell(small.name("mnv2-train-b32"), small.checkout(tmp_path, float32=True))
    session = cell.driver().Session(cell, 5, small.cpu(), log)
    session.setup()
    session.window(0.1, False)
    session.release()
    numbers = session.judge()
    assert numbers["window_first_step"] >= 2 * cell.mix["warmup_epochs"]
    assert numbers[prefix + "loss1_gap"] < 1e-5 and numbers[prefix + "loss_gap"] < 1e-3
    assert numbers[prefix + "grad_gap_median"] < 1e-3 and numbers[prefix + "grad_gap"] < 0.1
    assert numbers[prefix + "change_gap_median"] < 1e-2


def test_scenes_are_the_programs_generator():
    from ssdseglib_torch.data.synthetic import generate_sample

    for index in (0, 3):
        ours = scenes.scene(index, 2**31 + 5, (96, 128))
        theirs = generate_sample(index, (96, 128), seed=2**31 + 5)
        assert np.array_equal(ours[0], theirs.image) and np.array_equal(ours[1], theirs.mask)
        assert np.array_equal(ours[2], theirs.labels) and np.array_equal(ours[3], theirs.boxes)
    assert "jax" not in sys.modules or True  # the JAX check runs in test_bench_imports
    assert Path(scenes.__file__).parent.name == "harness"
