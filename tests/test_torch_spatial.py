"""The port's spatial (H-axis) parallelism (ssdseglib_torch.parallel.spatial)
on four gloo ranks on the CPU, on a 2x2 and a 1x4 ``("data", "spatial")``
mesh (standing in for the JAX spatial tests' 2x4 and 1x8), against the port
in one process and against the JAX package's own hybrid mesh (the virtual CPU
devices of tests/conftest.py).

The ranks run in four spawned processes (tests/torch_spatial_workers.py,
which imports nothing of JAX), once for the whole file; this process
prepares the inputs, runs the references while the ranks work, and
compares.  The model is the JAX spatial tests' reduced one (96x128, anchors
(6,8) (3,4) (2,2) (1,1), dilations 3/6/12), its weights the port's init
with random BatchNorm, carried to the JAX package by
`weights.to_flax_variables` (the JAX package's own init takes ~33 s here,
before the ranks could start).

Gates:
- the row ops alone (every window, the pool, the resizes, the mean, the
  gather), forward and input gradient in f64 against the global op: 1e-12
  of the largest magnitude (only the summation order differs).
- serving: mask rtol 1e-4 / atol 1e-5, detections rtol 1e-3 / atol 1e-4,
  the JAX spatial serving test's (tests/test_spatial_parallel.py); against
  JAX's own 1x4 hybrid mesh, the port's cross-framework serving gates (mask
  2e-3, detections' labels equal and the rest 1e-4: tests/test_torch_serving.py).
- one f32 step on 2x2 at b8: metrics rtol 2e-3 / atol 2e-4 (the JAX
  spatial test's); every parameter's gradient within 1e-4 of one process in
  the relative-norm metric of tests/test_torch_train.py, taken in f64
  through the trainer's own pieces (in f32 the backward of ~60 stacked
  train-mode BatchNorms carries noise of up to 5e-2 whatever the reduction
  order, tests/test_torch_train.py, so the f32 gradients are held to that);
  the replicas' parameters bitwise equal; the running statistics within 1e-5
  of each tensor's largest magnitude (tests/test_torch_parallel.py).
- must-miss: the serving case with the halo rows left at zero, and the step
  with the mask losses' spatial sums skipped, miss those gates.
"""

import jax
import numpy as np
import pytest
import torch

from ssdseglib_tpu.models import MobileNetV2SsdSegBuilder as JaxBuilder
from ssdseglib_tpu.parallel import spatial as jax_spatial

from ssdseglib_torch import parallel
from ssdseglib_torch.config import ModelConfig
from ssdseglib_torch.models.builder import SsdSegModel
from ssdseglib_torch.parallel import spatial
from ssdseglib_torch.weights import to_flax_variables
from tests import torch_dp_workers as W
from tests import torch_spatial_workers as S
from tests.test_torch_parallel import (
    METRIC_GATE,
    Ranks,
    _assert_replicas_equal,
    _batch,
    _worst_relative_norm_error,
)
from tests.torch_parity import images
from tests.torch_parity import two_torch_threads  # noqa: F401

MASK_GATE = dict(rtol=1e-4, atol=1e-5)
DETECTION_GATE = dict(rtol=1e-3, atol=1e-4)
F64_GATE = 1e-4
F32_GRADIENT_GATE = 5e-2


def _jax_builder():
    centroids = W.anchors().centroids
    return JaxBuilder(W.MODEL["input_image_shape"], 4, 4, centroids[:, 0], centroids[:, 1],
                      centroids[:, 2], centroids[:, 3], (0.1, 0.1, 0.2, 0.2))


def _randomized(model_cfg) -> dict:
    """A port model's state_dict at seed 0 with random BatchNorm
    (statistics and bias uniform in [0.5, 1.5], as tests/torch_parity.py
    draws them)."""
    state = SsdSegModel(ModelConfig(**model_cfg), torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(1)
    for key, value in state.items():
        if key.endswith(("running_mean", "running_var", "batchnorm.bias")):
            state[key] = torch.tensor(rng.uniform(0.5, 1.5, value.shape).astype(np.float32))
    return state


def _op_grads() -> dict:
    """An upstream gradient of each op's global output shape."""
    rng = np.random.default_rng(11)
    return {name: torch.from_numpy(rng.normal(size=tuple(S.apply_op(name, S.op_input(
        stride)).shape))) for name, (stride, _, _) in S.OPS.items()}


@pytest.fixture(scope="module")
def inputs():
    return {
        "variables": _randomized(W.MODEL),
        "shufflenet": _randomized(W.SHUFFLENET),
        "serve_images": images(5, (4, 96, 128, 3)),
        "batch": _batch(S.STEP_BATCH),
        "op_grads": _op_grads(),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    directory = tmp_path_factory.mktemp("spatial_parallel")
    torch.save(inputs, directory / "inputs.pt")
    started = Ranks(directory, run=S.run, world=S.WORLD)
    try:
        yield started
    finally:
        started.stop()


def test_serving_matches_the_jax_hybrid_mesh(inputs, ranks):
    """Runs first, so that the JAX compile overlaps the ranks' work: the
    port's 1x4 b1 serving on four ranks against the JAX package's own
    make_hybrid_mesh(1, 4) serving of the same weights."""
    mesh = jax_spatial.make_hybrid_mesh(1, 4, jax.devices()[:4])
    builder = _jax_builder()
    builder.get_model_for_training(segmentation_dilation_rates=(3, 6, 12))  # the config
    jax_model = builder.get_model_for_inference(
        model_trained=to_flax_variables(inputs["variables"]), mesh=mesh,
        **S.SERVE_NO_SUPPRESSION)
    mask_j, det_j = jax_model.predict(inputs["serve_images"][:1])
    assert (det_j[..., 1] > 0).sum() >= 3  # several detections survive
    for result in ranks.results():
        mask, det = result["serving"]["1x4_b1"]
        np.testing.assert_allclose(mask, mask_j, rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(det[..., 0], det_j[..., 0])
        np.testing.assert_allclose(det[..., 1:], det_j[..., 1:], rtol=1e-4, atol=1e-4)


def test_hybrid_mesh_shape_and_shards(ranks):
    for rank, result in enumerate(ranks.results()):
        got = result["mesh"]
        assert got["2x2"]["shape"] == {"data": 2, "spatial": 2}
        assert got["1x4"]["shape"] == {"data": 1, "spatial": 4}
        assert list(got["2x2"]["coordinate"]) == [rank // 2, rank % 2]
        assert list(got["1x4"]["coordinate"]) == [0, rank]
        assert got["2x2"]["shard"] == (2, 48, 128, 3)
        assert got["1x4"]["shard"] == (4, 24, 128, 3)
        # this rank's block of the global batch: batch slice, then rows
        whole = np.arange(4 * 96, dtype=np.float32).reshape(4, 96)
        d, s = rank // 2, rank % 2
        np.testing.assert_array_equal(got["2x2"]["rows"], whole[2 * d:2 * d + 2,
                                                                48 * s:48 * s + 48])
        np.testing.assert_array_equal(got["1x4"]["rows"], whole[:, 24 * rank:24 * rank + 24])
        for name in ("2x2", "1x4"):
            assert got[name]["image_sharding"] == "(Shard(dim=0), Shard(dim=1))"
            assert got[name]["batch_sharding"] == "(Shard(dim=0), Replicate())"


def test_divisibility_and_device_errors(ranks):
    """The JAX spatial test's three errors, with its patterns."""
    import re

    for result in ranks.results():
        errors = result["mesh"]["errors"]
        assert re.search("divisible.*data|data.*divisible", errors["batch"]), errors
        assert re.search("height", errors["height"]), errors
        assert re.search("devices", errors["devices"]), errors


@pytest.mark.parametrize("height, width, n, halo, first_whole", [
    (96, 128, 4, 12, 16),   # 1x4 at 96x128: os16 has 6 rows, 1.5 a rank
    (96, 128, 2, 12, 16),   # 2x2: os16 has 3 rows a rank, under the 12-row halo
    (480, 640, 2, 12, 32),  # 1x2 and 2x2 at 480x640: os16 15 a rank, os32 7.5
    (480, 640, 4, 12, 16),  # 1x4 at 480x640: os16 7.5 a rank
])
def test_row_partition_levels(height, width, n, halo, first_whole):
    """Where each tested configuration's maps become whole (PERF.md §4)."""
    partition = spatial.RowPartition(height, width, n, 0, {16: halo})
    assert partition.first_whole() == first_whole
    for stride, rows, cols, split in partition.levels:
        assert (rows, cols) == (-(-height // stride), -(-width // stride))
        assert split == (stride < first_whole)


@pytest.mark.parametrize("name", list(S.OPS))
def test_row_ops_match_the_global_ops(inputs, ranks, name):
    """Each row op on the 1x4 mesh, forward and input gradient in f64,
    against the op on the global map: split results are the ranks' rows of
    the global ones, whole results the global ones on every rank (an input
    gradient of a whole input: the rank's share, a quarter)."""
    stride = S.OPS[name][0]
    x = S.op_input(stride).requires_grad_()
    y = S.apply_op(name, x)
    (dx,) = torch.autograd.grad(y, x, inputs["op_grads"][name])
    results = [r["ops"][name] for r in ranks.results()]
    for label, want, key, split in (("y", y.detach(), "y", results[0]["split_out"]),
                                    ("dx", dx, "dx", results[0]["split_in"])):
        parts = [r[key] for r in results]
        if split:
            got = torch.cat(parts, dim=2)
        else:
            got = parts[0]
            for part in parts[1:]:
                assert torch.equal(part, got), (name, label)
            if label == "dx":
                got = got * 4.0
        assert got.shape == want.shape, (name, label, got.shape, want.shape)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-12 * scale, (name, label)


def test_ops_cover_split_and_whole_transitions(ranks):
    results = ranks.results()[0]["ops"]
    kinds = {(r["split_in"], r["split_out"]) for name, r in results.items() if name != "levels"}
    assert kinds == {(True, True), (True, False), (False, True)}
    assert [split for *_, split in results["levels"][:5]] == [True, True, True, False, False]


@pytest.mark.parametrize("case", ["2x2_b4_suppression", "1x4_b1", "shufflenet_1x4_b1"])
def test_serving_matches_one_process(inputs, ranks, case):
    """The JAX spatial serving tests' cases: 2x2 at b4 with the segmentation
    suppression, 1x4 at b1 without, and ShuffleNetV2 on 1x4: the whole batch
    on every rank from `predict`, this rank's block from `__call__`."""
    (name, single, images_), = [c for c in S.serving_cases(
        inputs["variables"], inputs["shufflenet"], inputs["serve_images"], lambda m: None)
        if c[0] == case]
    mask, det = single.predict(images_)
    assert (det[..., 1] > 0).sum() >= 3
    for result in ranks.results():
        got_mask, got_det = result["serving"][case]
        np.testing.assert_allclose(got_mask, mask, **MASK_GATE)
        np.testing.assert_allclose(got_det, det, **DETECTION_GATE)
        n_data, n_spatial = (2, 2) if case.startswith("2x2") else (1, 4)
        b = images_.shape[0] // n_data
        assert result["serving"][case, "call"] == ((b, 96 // n_spatial, 128, 4), (b, 10, 6))


@pytest.fixture(scope="module")
def single_step(inputs):
    """One process's f32 step at b8 and its f64 gradient."""
    images, targets = inputs["batch"]
    return (W.one_step(None, inputs["variables"], images, targets, batch_size=S.STEP_BATCH),
            S.grads64(None, inputs["variables"], images, targets))


def test_train_step_matches_one_process(ranks, single_step):
    """One f32 step on 2x2 at b8 against one process at b8: metrics,
    every parameter's gradient (in f64, and in f32 at its noise), the
    replicas bitwise equal, the running statistics."""
    want, (exact, _) = single_step
    results = [r["step"] for r in ranks.results()]
    for result in results:
        got = result["f32"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **METRIC_GATE)
        worst = _worst_relative_norm_error(result["f64"][0], exact)
        assert worst[0] <= F64_GATE, worst
        worst32 = _worst_relative_norm_error(got["grads"], want["grads"])
        assert worst32[0] < F32_GRADIENT_GATE, worst32
        for k, v in want["batch_stats"].items():
            scale = float(v.abs().max())
            np.testing.assert_allclose(got["batch_stats"][k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=k)
    for result in results[1:]:
        _assert_replicas_equal(results[0]["f32"]["params"], result["f32"]["params"])
        _assert_replicas_equal(results[0]["f32"]["batch_stats"], result["f32"]["batch_stats"])


def test_weight_gradient_route_runs_on_the_shards(ranks, single_step):
    """set_wgrad_impl('cuda') on the spatial step (on the CPU, the kernels'
    plain versions): a 1x1 conv has no halo and its partial weight gradient
    is summed by the step's gradient mean."""
    want, _ = single_step
    for result in ranks.results():
        got = result["step"]["wgrad_cuda"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **METRIC_GATE)
        worst = _worst_relative_norm_error(got["grads"], want["grads"])
        assert worst[0] < F32_GRADIENT_GATE, worst


def test_must_miss_variants_fail_the_gates(inputs, ranks, single_step):
    """The serving case with the halo rows left at zero, and the step with
    the mask losses' spatial sums skipped: both miss the parity gates."""
    (_, single, images_), = [c for c in S.serving_cases(
        inputs["variables"], inputs["shufflenet"], inputs["serve_images"], lambda m: None)
        if c[0] == "2x2_b4_suppression"]
    mask, _ = single.predict(images_)
    want, (exact, _) = single_step
    for result in ranks.results():
        got_mask, _ = result["serving"]["2x2_b4_suppression", "no_halo"]
        assert not np.allclose(got_mask, mask, **MASK_GATE)
        grads, metrics = result["step"]["local_mask_sums"]
        assert not np.allclose(metrics["loss/mask"], want["metrics"]["loss/mask"],
                               **METRIC_GATE)
        assert _worst_relative_norm_error(grads, exact)[0] > 100 * F64_GATE


def test_fit_routes_images_through_shard_images(inputs, ranks):
    """Trainer.fit on 2x2 over a loader built with the mesh: every batch the
    step sees went through shard_images on the 2-D mesh, which took its
    rows (the loader its batch slice); the epoch's metrics are one
    process's."""
    trainer = W.trainer(batch_size=S.STEP_BATCH)
    state = trainer.init_state(variables=inputs["variables"])
    _, want = trainer.fit(state, S.fit_loader(), epochs=1, log_fn=lambda s: None)
    for result in ranks.results():
        got = result["fit"]
        assert got["step"] == 1
        assert got["seen"] == [{"axes": ("data", "spatial"), "in": (4, 96, 128, 3),
                                "out": (4, 48, 128, 3)}]
        for k, v in want.items():
            np.testing.assert_allclose(got["history"][k][0], v[0], err_msg=k, **METRIC_GATE)


@pytest.mark.parametrize("route", ["fused_backbone", "s2d_stem", "depthwise_bwd", "chain_bwd"])
def test_kernel_routes_refuse_a_spatial_mesh(ranks, route):
    """The routes whose kernels pad SAME inside the kernel raise
    NotImplementedError naming the ROADMAP item; none falls back."""
    for result in ranks.results():
        message = result["gates"][route]
        assert message is not None and spatial.ROADMAP_ITEM in message, message


def test_parallel_surface_is_the_jax_package_s():
    import ssdseglib_tpu.parallel

    assert parallel.__all__ == ssdseglib_tpu.parallel.__all__
    assert parallel.SPATIAL_AXIS == jax_spatial.SPATIAL_AXIS == "spatial"
