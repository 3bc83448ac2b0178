"""The program's spans (`utils.profiling.span`): recorded only while a
``torch.profiler`` session records, on every thread, on the profiler's
clock; placed in `InferenceModel.__call__`, `Trainer.fit` and the loader;
and the serving call split into its spanned steps serves the same bits as
`serving_program`.  CPU, 96x128."""

import contextlib
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import AnchorsConfig, EncodingConfig, ModelConfig, TrainConfig
from ssdseglib_torch.data.pipeline import TrainDataLoader
from ssdseglib_torch.data.synthetic import generate_dataset
from ssdseglib_torch.models.builder import MobileNetV2SsdSegBuilder, SsdSegModel
from ssdseglib_torch.train import Trainer
from ssdseglib_torch.utils import profiling
from tests.torch_parity import two_torch_threads  # noqa: F401

IMAGE_SHAPE = (96, 128)
ANCHORS = AnchorsConfig(
    feature_maps_shapes=((6, 8), (3, 4), (2, 2), (1, 1)),
    feature_maps_aspect_ratios=((1.0, 2.0, 0.5),) * 4,
    boxes_scales=(0.2, 0.9),
    centers_padding_from_borders=(0.05, 0.05, 0.05, 0.05),
    additional_square_box=True,
)


def _recorded(fn):
    """The spans that ``fn()`` records under a CPU profiler, and the
    profiler."""
    before = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return profiling.spans()[before:], prof


@pytest.fixture(scope="module")
def inference():
    anchors = Anchors.from_config(ANCHORS, IMAGE_SHAPE)
    builder = MobileNetV2SsdSegBuilder(
        input_image_shape=(*IMAGE_SHAPE, 3), number_of_boxes_per_point=4, number_of_classes=4,
        center_x_boxes_default=anchors.center_x, center_y_boxes_default=anchors.center_y,
        width_boxes_default=anchors.width, height_boxes_default=anchors.height,
        standard_deviations_centroids_offsets=(0.1, 0.1, 0.2, 0.2),
    )
    model = builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12), device="cpu",
                                           generator=torch.Generator().manual_seed(0))
    inf = builder.get_model_for_inference(
        model_trained=model, device="cpu", max_number_of_boxes_per_class=4,
        max_number_of_boxes_per_sample=10, boxes_iou_threshold=0.5,
        labels_probability_threshold=0.26, suppress_background_boxes=False,
        use_segmentation_suppression=True, compute_dtype="bfloat16", fused_backbone=True,
        mask_output="bfloat16")
    images = np.random.default_rng(0).integers(0, 256, (2, *IMAGE_SHAPE, 3), dtype=np.uint8)
    return inf, images


def test_outside_a_profiler_a_span_records_and_allocates_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    before = len(profiling.spans())
    assert profiling.span("a") is profiling.span("b", 1, 2.0)
    # allocations made by these lines, the recorder and the no-op context
    # alone, whatever other threads of the process do meanwhile
    files = [tracemalloc.Filter(True, f) for f in (__file__, profiling.__file__,
                                                    contextlib.__file__)]
    tracemalloc.start()
    try:
        before_loop = tracemalloc.take_snapshot().filter_traces(files)
        for i in range(1000):
            with profiling.span("serve.request", 7, 3.0):
                with profiling.span("serve.stage", 7):
                    pass
        after_loop = tracemalloc.take_snapshot().filter_traces(files)
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in after_loop.compare_to(before_loop, "filename"))
    assert grown < 512
    assert len(profiling.spans()) == before


def test_a_span_records_on_every_thread_while_a_profiler_records():
    def worker():
        with profiling.span("worker", 1):
            pass

    def both():
        with profiling.span("main", 0, 5):
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=10)
            assert not thread.is_alive()

    records, _ = _recorded(both)
    by_name = {r.name: r for r in records}
    assert set(by_name) == {"main", "worker"}
    assert by_name["main"].thread == threading.get_ident() != by_name["worker"].thread
    assert by_name["worker"].parent is None and by_name["main"].value == 5
    assert not torch.autograd.profiler._is_profiler_enabled
    after = len(profiling.spans())
    with profiling.span("after"):
        pass
    assert len(profiling.spans()) == after


def test_a_span_shares_the_profilers_clock():
    def ranged():
        with profiling.span("outer"):
            time.sleep(0.002)
            with record_function("inner_range"):
                time.sleep(0.005)
            time.sleep(0.002)

    records, prof = _recorded(ranged)
    (outer,) = records
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner_range"]
    start, end = event.start_ns(), event.start_ns() + event.duration_ns()
    assert outer.start_ns - 1_000_000 <= start and end <= outer.end_ns + 1_000_000
    assert start - outer.start_ns >= 1_000_000 and outer.end_ns - end >= 1_000_000


def test_a_serving_call_records_its_request_and_steps(inference):
    inf, images = inference
    call = inf._calls
    records, _ = _recorded(lambda: inf(images))
    by_name = {r.name: r for r in records}
    assert set(by_name) == {"serve.request", "serve.stage", "serve.core", "serve.nms"}
    request = by_name["serve.request"]
    assert request.parent is None and request.index == call
    for name in ("serve.stage", "serve.core", "serve.nms"):
        child = by_name[name]
        assert child.parent == "serve.request" and child.index == call
        assert child.thread == request.thread
        assert request.start_ns <= child.start_ns <= child.end_ns <= request.end_ns
    assert (by_name["serve.stage"].end_ns <= by_name["serve.core"].start_ns
            and by_name["serve.core"].end_ns <= by_name["serve.nms"].start_ns)


def test_the_spanned_call_serves_the_bits_of_serving_program(inference):
    inf, images = inference
    mask, det = inf(images)
    with torch.inference_mode():
        want_mask, want_det = inf.serving_program(
            inf._operands, inf.prepare_input(images), inf._iou_threshold, inf._score_threshold)
    assert mask.dtype == want_mask.dtype and det.dtype == want_det.dtype
    assert torch.equal(mask.view(torch.int16), want_mask.view(torch.int16))
    assert torch.equal(det.view(torch.int32), want_det.view(torch.int32))


def test_a_fit_epoch_records_epoch_stage_steps_and_loader():
    anchors = Anchors.from_config(ANCHORS, IMAGE_SHAPE)
    model = SsdSegModel(ModelConfig(input_image_shape=(*IMAGE_SHAPE, 3), number_of_classes=4,
                                    boxes_per_point=(4, 4, 4, 4), backbone="mobilenetv2",
                                    segmentation_dilation_rates=(3, 6, 12)),
                        torch.Generator().manual_seed(0))
    trainer = Trainer(model=model, anchors=anchors,
                      config=TrainConfig(batch_size=2, learning_rate=3e-4, epochs=1), device="cpu")
    loader = TrainDataLoader(generate_dataset(4, image_shape=IMAGE_SHAPE, seed=3), anchors,
                             EncodingConfig(num_classes=4, image_shape=IMAGE_SHAPE,
                                            iou_threshold=0.35, max_ground_truth_boxes=16),
                             batch_size=2, seed=0, num_workers=2, device="cpu")
    state = trainer.init_state()
    records, _ = _recorded(lambda: trainer.fit(state, loader, epochs=1, log_fn=lambda m: None))
    main = threading.get_ident()
    named = {}
    for r in records:
        named.setdefault(r.name, []).append(r)
    assert set(named) == {"train.epoch", "train.stage", "train.step", "loader.wait",
                          "loader.batch"}
    (epoch,) = named["train.epoch"]
    assert epoch.index == 0 and epoch.parent is None and epoch.thread == main
    (stage,) = named["train.stage"]
    assert stage.index == 0 and stage.parent == "train.epoch"
    assert [r.index for r in named["train.step"]] == [0, 1]
    assert all(r.parent == "train.epoch" and r.thread == main for r in named["train.step"])
    # two batches and the end of the epoch, each waited for on the queue
    assert [r.index for r in named["loader.wait"]] == [0, 1, 2]
    assert all(r.thread == main and r.value >= 0 for r in named["loader.wait"])
    assert sorted(r.index for r in named["loader.batch"]) == [0, 1]
    assert all(r.thread != main and r.parent is None for r in named["loader.batch"])
    for r in records:
        if r.thread == main and r is not epoch:
            assert epoch.start_ns <= r.start_ns <= r.end_ns <= epoch.end_ns

