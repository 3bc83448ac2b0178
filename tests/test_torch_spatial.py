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
- the hand-written kernels on row windows (their plain versions on the
  CPU): fused serving (1x4 b1; 2x2 b4 with int8 pointwise convs; 1x4 with
  ``s2d_stem='cuda'``) against one process's fused serving at the serving
  gates above; f32 serving on 2x2 at b2 under ``set_depthwise_impl("shift")``
  against one process under "shift" at the serving gates; the fused
  forward on 1x4 against the JAX package's
  make_fused_forward (Pallas in interpret mode) on one device at
  tests/test_torch_fused_inference.py's 2e-3; one f32 step on 2x2 with the
  depthwise and with the chain backward gate 'cuda' (envelopes read at the
  flagship's size) against one process with the same gate and against the
  mesh's ATen route, at the step gates above; each windowed plain version
  alone (no ranks) on a top, an inner and a bottom window against the same
  plain version on the whole map's rows in f32: exact for the MBConv and
  the stem, and for the stem's packed conv reformulation (``s2d_stem="xla"``)
  on the same windows (each output reads the same values in the same
  order), 2e-6 of
  the largest magnitude for the depthwise and chain backward (dx at a
  window's edge and dk sum the windows' parts in another order).
- must-miss: the serving case with the halo rows left at zero, the fused
  serving with the MBConv padding SAME at an inner edge or padding x where
  the expanded tensor should be padded, the step with the mask losses'
  spatial sums skipped, the chain step with its statistics and sums over
  the data group alone, and each backward gate's step with its backward
  alone broken (the depthwise dx's halo rows dropped; the chain's du over
  the whole window), miss those gates; the last two pass the metric gate
  and fail the f32 gradient gate.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssdseglib_tpu.config import ModelConfig as JaxModelConfig
from ssdseglib_tpu.models import MobileNetV2SsdSegBuilder as JaxBuilder
from ssdseglib_tpu.models import fused_inference as jax_fused
from ssdseglib_tpu.parallel import spatial as jax_spatial

from ssdseglib_torch import parallel
from ssdseglib_torch.config import ModelConfig
from ssdseglib_torch.models import blocks
from ssdseglib_torch.models.builder import SsdSegModel
from ssdseglib_torch.models.fused_inference import STEM_HALO
from ssdseglib_torch.ops import depthwise_backward as dwb
from ssdseglib_torch.ops import fused_chain_backward as fcb
from ssdseglib_torch.ops import fused_mbconv as fm
from ssdseglib_torch.ops import s2d_stem
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
JAX_FUSED_GATE = 2e-3  # tests/test_torch_fused_inference.py's, the JAX package's own bound
WINDOW_SUM_GATE = 2e-6  # of the largest magnitude: the windows' parts summed in another order
# OIHW shapes of the six folded convs of the stem and block 1
STEM_OIHW = ((32, 3, 3, 3), (32, 1, 3, 3), (16, 32, 1, 1), (96, 16, 1, 1), (96, 1, 3, 3),
             (24, 96, 1, 1))


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
def jax_fused_outputs(inputs):
    """The JAX package's fused forward (Pallas in interpret mode) of the same
    weights on one device, f32, b1: run once for the file."""
    cfg = JaxModelConfig(**W.MODEL)
    forward = jax_fused.make_fused_forward(cfg, to_flax_variables(inputs["variables"]),
                                           compute_dtype=jnp.float32, interpret=True)
    out = forward(jnp.asarray(inputs["serve_images"][:1]))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    directory = tmp_path_factory.mktemp("spatial_parallel")
    torch.save(inputs, directory / "inputs.pt")
    started = Ranks(directory, run=S.run, world=S.WORLD)
    try:
        yield started
    finally:
        started.stop()


def test_serving_matches_the_jax_hybrid_mesh(inputs, ranks, jax_fused_outputs):
    """Runs first, so that the JAX compiles (this test's and the fused
    forward's, `jax_fused_outputs`) overlap the ranks' work: the port's 1x4
    b1 serving on four ranks against the JAX package's own
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


def test_must_miss_variants_fail_the_gates(inputs, ranks, single_step, gated_steps):
    """The serving case with the halo rows left at zero, the step with the
    mask losses' spatial sums skipped, the fused serving with the MBConv
    padding SAME at an inner edge or padding x where the expanded tensor
    should be padded, the chain step with its statistics and sums over the
    data group alone, and each backward gate's step with its backward alone
    broken (`torch_spatial_workers.backward_fault`: the depthwise dx's halo
    rows dropped, the chain's du over the whole window): each misses the
    parity gates."""
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
    (_, fused, images_), = [c for c in S.fused_cases(
        inputs["variables"], inputs["serve_images"], lambda m: None) if c[0] == "fused_1x4_b1"]
    fused_mask, _ = fused.predict(images_)
    chain_want = gated_steps["chain"]
    for result in ranks.results():
        for variant in ("mbconv_same_at_inner_edges", "mbconv_pad_x"):
            got_mask, _ = result["fused"][variant]
            assert not np.allclose(got_mask, fused_mask, **MASK_GATE), variant
        with pytest.raises(AssertionError):
            _assert_step_close(result["kernel_step"]["chain_data_group"], chain_want)
        for route in ("depthwise", "chain"):
            # the route's backward broken alone: the forward's metrics and
            # statistics pass, the gradient gate fails
            fault = result["kernel_step"][route, "fault"]
            for want in (result["step"]["f32"], gated_steps[route]):
                for k, v in want["metrics"].items():
                    np.testing.assert_allclose(fault["metrics"][k], v, err_msg=k, **METRIC_GATE)
                worst = _worst_relative_norm_error(fault["grads"], want["grads"])
                assert worst[0] > F32_GRADIENT_GATE, (route, worst)


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


def _rows_of_ranks(results, key, n=4):
    """The ranks' row blocks of a raw forward's mask, in row order (1x4)."""
    return np.concatenate([r["fused"][key]["output-mask"].numpy() for r in results[:n]], axis=1)


@pytest.mark.parametrize("case", ["fused_1x4_b1", "fused_int8_2x2_b4", "s2d_stem_1x4_b1"])
def test_kernels_on_windows_serve_as_one_process(inputs, ranks, case):
    """The fused serving path on split rows, the kernels' plain versions on
    the CPU: `predict` (and this rank's block from `__call__`) of the fused
    model on 1x4 and of the int8 one on 2x2, and the raw outputs of
    ``make_fused_forward(s2d_stem='cuda')`` on 1x4, against one process."""
    results = ranks.results()
    if case == "s2d_stem_1x4_b1":
        want = S.raw_forward(inputs["variables"], None, inputs["serve_images"][:1], "cuda")
        np.testing.assert_allclose(_rows_of_ranks(results, "raw_s2d"),
                                   want["output-mask"].numpy(), **MASK_GATE)
        for result in results:
            for key in ("output-labels", "output-boxes"):
                np.testing.assert_allclose(result["fused"]["raw_s2d"][key].numpy(),
                                           want[key].numpy(), err_msg=key, **MASK_GATE)
        return
    (_, single, images_), = [c for c in S.fused_cases(
        inputs["variables"], inputs["serve_images"], lambda m: None) if c[0] == case]
    mask, det = single.predict(images_)
    assert (det[..., 1] > 0).sum() >= 3
    n_data, n_spatial = (2, 2) if "2x2" in case else (1, 4)
    b = images_.shape[0] // n_data
    for result in results:
        got_mask, got_det = result["fused"][case]
        np.testing.assert_allclose(got_mask, mask, **MASK_GATE)
        np.testing.assert_allclose(got_det, det, **DETECTION_GATE)
        assert result["fused"][case, "call"] == ((b, 96 // n_spatial, 128, 4), (b, 10, 6))


def test_fused_forward_on_1x4_matches_the_jax_fused_forward(ranks, jax_fused_outputs):
    """The slice against the JAX package: the port's fused forward on the 1x4
    mesh (its kernels' plain versions on row windows) against the JAX
    package's make_fused_forward on one device (Pallas in interpret mode)."""
    results = ranks.results()
    np.testing.assert_allclose(_rows_of_ranks(results, "raw"), jax_fused_outputs["output-mask"],
                               rtol=JAX_FUSED_GATE, atol=JAX_FUSED_GATE)
    for result in results:
        for key in ("output-labels", "output-boxes"):
            np.testing.assert_allclose(result["fused"]["raw"][key].numpy(),
                                       jax_fused_outputs[key], rtol=JAX_FUSED_GATE,
                                       atol=JAX_FUSED_GATE, err_msg=key)


@pytest.fixture(scope="module")
def gated_steps(inputs):
    """One process's f32 step at b8 under each backward gate."""
    images, targets = inputs["batch"]
    out = {}
    for route in ("depthwise", "chain"):
        with S.backward_gate(route):
            out[route] = W.one_step(None, inputs["variables"], images, targets,
                                    batch_size=S.STEP_BATCH)
    return out


def _assert_step_close(got, want):
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **METRIC_GATE)
    worst = _worst_relative_norm_error(got["grads"], want["grads"])
    assert worst[0] < F32_GRADIENT_GATE, worst
    for k, v in want["batch_stats"].items():
        scale = float(v.abs().max())
        np.testing.assert_allclose(got["batch_stats"][k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("route", ["depthwise", "chain"])
def test_backward_kernels_on_windows_step_as_one_process(ranks, gated_steps, route):
    """One f32 step on 2x2 with the route's gate 'cuda' (its kernel's plain
    version on each rank's window of block0-depthwise): against one process
    with the same gate and against the mesh's ATen route, at the step gates;
    the replicas equal; the unit ran on windows (two halo rows)."""
    results = ranks.results()
    for result in results:
        got = result["kernel_step"][route]
        _assert_step_close(got, gated_steps[route])
        _assert_step_close(got, result["step"]["f32"])
        windows = result["kernel_step"][route, "windows"]
        assert windows == [(S.STEP_BATCH // 2, 32, 48 // 2 + 2, 64)], windows
    for result in results[1:]:
        _assert_replicas_equal(results[0]["kernel_step"][route]["params"],
                               result["kernel_step"][route]["params"])
        _assert_replicas_equal(results[0]["kernel_step"][route]["batch_stats"],
                               result["kernel_step"][route]["batch_stats"])


def test_shift_depthwise_serves_as_one_process(inputs, ranks):
    """f32 `predict` at b2 on 2x2 (each data group's image split in two
    rows, 1x2) under ``set_depthwise_impl("shift")``: the shifted taps on
    `window_rows`' windows against one process under "shift"."""
    blocks.set_depthwise_impl("shift")
    try:
        mask, det = S._serve(inputs["variables"], None, **S.SERVE_NO_SUPPRESSION).predict(
            inputs["serve_images"][:2])
    finally:
        blocks.set_depthwise_impl("conv")
    for result in ranks.results():
        got_mask, got_det = result["shift"]["predict"]
        np.testing.assert_allclose(got_mask, mask, **MASK_GATE)
        np.testing.assert_allclose(got_det, det, **DETECTION_GATE)


def test_backward_envelopes_read_the_global_rows(ranks):
    """On 1x4 at block0-depthwise's flagship map (32 channels at 240x320,
    2.46 M values; a shard's 60 rows hold 614 k, under the envelopes' 1 M)
    each backward route takes its unit on every rank: the envelope read the
    global rows, as one process would."""
    assert dwb.pallas_bwd_applicable(240, 320, 32, (3, 3), (1, 1), (1, 1))
    assert not dwb.pallas_bwd_applicable(60, 320, 32, (3, 3), (1, 1), (1, 1))
    assert not fcb.chain_applicable(60, 320, 32, (3, 3), (1, 1), (1, 1), 6.0)
    for result in ranks.results():
        got = result["envelopes"]
        assert got["depthwise"]["grad_fn"] == "_DepthwiseConv3x3FusedBwdBackward", got
        assert got["chain"]["grad_fn"] == "_DwBnRelu6ChainBackward", got
        for route in ("depthwise", "chain"):
            assert got[route]["dx"] == got[route]["y"] == (1, 32, 60, 320), got


def _windows(rows: int, n: int = 4):
    """(rank, first, stop) of the top, an inner and the bottom shard of
    ``rows`` split ``n`` ways."""
    h = rows // n
    return [(r, r * h, (r + 1) * h) for r in (0, 1, n - 1)]


def _mbconv_windows(gen):
    x = torch.randn(2, 24, 16, 8, generator=gen)
    args = (torch.randn(8, 32, generator=gen) / 3, torch.randn(32, generator=gen) * 0.1,
            torch.randn(9, 32, generator=gen) / 3, torch.randn(32, generator=gen) * 0.1,
            torch.randn(32, 8, generator=gen) / 6, torch.randn(8, generator=gen) * 0.1)
    whole = fm.fused_mbconv(x, *args)
    for _, first, stop in _windows(24):
        a, b = max(first - 1, 0), min(stop + 1, 24)
        got = fm.fused_mbconv(x[:, a:b].contiguous(), *args)[:, first - a:first - a + stop - first]
        yield got, whole[:, first:stop], 0.0


def _stem_windows(gen):
    folded = []
    for w_shape, b_shape in s2d_stem._SHAPES:
        folded += [torch.randn(*w_shape, generator=gen) * w_shape[0] ** -0.5,
                   torch.randn(*b_shape, generator=gen) * 0.1]
    images = torch.rand(2, 96, 32, 3, generator=gen) * 2.0 - 1.0
    whole = s2d_stem.fused_stem_block1(images, folded)
    before, after = STEM_HALO
    for _, first, stop in _windows(96):
        a, b = max(first - before, 0), min(stop + after, 96)
        got = s2d_stem.fused_stem_block1(images[:, a:b].contiguous(), folded)
        yield got[:, (first - a) // 4:(stop - a) // 4], whole[:, first // 4:stop // 4], 0.0


def _stem_xla_windows(gen):
    """The packed conv reformulation (``s2d_stem="xla"``) on the stem
    kernel's windows (`STEM_HALO`): the same function, so the same rows."""
    folded = {name: ((torch.randn(*shape, generator=gen) * math.prod(shape[1:]) ** -0.5).numpy(),
                     (torch.randn(shape[0], generator=gen) * 0.1).numpy())
              for name, shape in zip(s2d_stem._NAMES, STEM_OIHW)}
    packed = [torch.from_numpy(a) for a in s2d_stem.pack_stem_block1(folded)]
    images = torch.rand(4, 96, 32, 3, generator=gen) * 2.0 - 1.0
    whole = s2d_stem.s2d_stem_block1_xla(images, packed)
    before, after = STEM_HALO
    for _, first, stop in _windows(96):
        a, b = max(first - before, 0), min(stop + after, 96)
        got = s2d_stem.s2d_stem_block1_xla(images[:, a:b].contiguous(), packed)
        yield got[:, (first - a) // 4:(stop - a) // 4], whole[:, first // 4:stop // 4], 0.0


def _backward_windows(gen, chain: bool):
    """The depthwise (or chain) backward on each window of a 4-way split:
    one fill row each side, dy padded by a zero row at each end (the chain:
    u over the window, pass 1's sums summed over the windows as the mesh
    sums them, du confined to the own rows).  The windows' dx added into the
    map's rows (a halo row's share goes to its owner) against the map's dx
    on the top, an inner and the bottom shard; their dk summed against the
    map's."""
    b, h, w, c = 2, 24, 16, 8
    x = torch.randn(b, h, w, c, generator=gen)
    dy = torch.randn(b, h, w, c, generator=gen)
    k = torch.randn(3, 3, 1, c, generator=gen)
    xp = F.pad(x, (0, 0, 0, 0, 1, 1))
    rows = h // 4
    windows = [(xp[:, r * rows:(r + 1) * rows + 2].contiguous(),
                F.pad(dy[:, r * rows:(r + 1) * rows], (0, 0, 0, 0, 1, 1))) for r in range(4)]
    if not chain:
        want_dx, want_dk = dwb.depthwise3x3_backward(x, dy, k)
        parts = [dwb.depthwise3x3_backward(xw, dyw, k) for xw, dyw in windows]
    else:
        gamma = torch.rand(c, generator=gen) + 0.5
        beta = torch.rand(c, generator=gen)
        weight = k.permute(3, 2, 0, 1)
        _, u, mean, var, coef = fcb._forward_math(x.permute(0, 3, 1, 2), weight, gamma, beta)
        want_dx, want_dk, _, _ = fcb.dw_bn_relu6_backward_reference(
            x, u.permute(0, 2, 3, 1).contiguous(), dy, k, gamma, beta, mean, var, coef)
        us = [F.conv2d(xw.permute(0, 3, 1, 2), weight, None, 1, 1, 1, c)
              .permute(0, 2, 3, 1).contiguous() for xw, _ in windows]
        totals = sum(fcb.chain_sums_reference(uw, dyw, coef)
                     for uw, (_, dyw) in zip(us, windows))
        parts = [fcb.chain_apply_reference(xw, uw, dyw, k, coef, totals, float(b * h * w),
                                           rows=(1, rows + 1))
                 for uw, (xw, dyw) in zip(us, windows)]
    dx = torch.zeros(b, h + 2, w, c)
    for r, (part, _) in enumerate(parts):
        dx[:, r * rows:(r + 1) * rows + 2] += part
    for _, first, stop in _windows(h):
        yield dx[:, first + 1:stop + 1], want_dx[:, first:stop], WINDOW_SUM_GATE
    yield sum(dk for _, dk in parts), want_dk, WINDOW_SUM_GATE


@pytest.mark.parametrize("kernel", ["mbconv", "stem", "stem_xla", "depthwise_backward",
                                    "chain_backward"])
def test_windowed_plain_versions_match_the_whole_map(kernel):
    """Each kernel's plain version on row windows, without ranks, on
    the top, an inner and the bottom window of a 4-way split, against the
    same plain version on the whole map's rows, f32; and the stem's packed
    conv reformulation, which takes the stem kernel's windows."""
    gen = torch.Generator().manual_seed(7)
    cases = {"mbconv": _mbconv_windows, "stem": _stem_windows, "stem_xla": _stem_xla_windows,
             "depthwise_backward": lambda g: _backward_windows(g, chain=False),
             "chain_backward": lambda g: _backward_windows(g, chain=True)}[kernel](gen)
    for got, want, gate in cases:
        assert got.shape == want.shape
        if gate == 0.0:
            assert torch.equal(got, want), float((got - want).abs().max())
        else:
            err = float((got - want).abs().max())
            assert err <= gate * float(want.abs().max()), err


def test_parallel_surface_is_the_jax_package_s():
    import ssdseglib_tpu.parallel

    assert parallel.__all__ == ssdseglib_tpu.parallel.__all__
    assert parallel.SPATIAL_AXIS == jax_spatial.SPATIAL_AXIS == "spatial"
