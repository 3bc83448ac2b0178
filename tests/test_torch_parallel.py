"""The port's data parallelism (ssdseglib_torch.parallel) on two gloo ranks on
the CPU, against the single process on the global batch and against the JAX
package's 2-device mesh (the virtual CPU devices of tests/conftest.py).

The ranks run in two spawned processes (tests/torch_dp_workers.py, which
imports nothing of JAX), once for the whole file; this process prepares the
inputs, runs the references while the ranks work, and compares.  The
reduced model is the JAX mesh tests' 96x128 one, at a global batch of 4
(2 a rank) for the steps and 8 (4 a rank) for serving.

Gates:
- one step's metrics: rtol 2e-3 / atol 2e-4 against one process, the JAX
  data-parallel test's gate (tests/test_train.py); against the JAX package's
  2-device mesh step, rtol 5e-5, the gate of the port's one-step test against
  JAX (tests/test_torch_train.py).
- gradients: the relative-norm metric of tests/test_torch_train.py below
  5e-2 (f32 gradients of ~60 stacked train-mode BatchNorms carry noise of
  that order whatever the reduction order).
- running statistics: per tensor, within 1e-5 of its largest magnitude (the
  one-process step's library BatchNorm takes a two-pass variance, the ranks
  Flax's E[x^2] - E[x]^2, times the momentum 0.01).
- the replicas' parameters after a step, a fit or a resume: bitwise equal.
- hard-negative mining: the ranks' per-sample losses equal the one-process
  losses to rtol 1e-6 (the same arithmetic per sample).
- serving: mask rtol 1e-4 / atol 1e-5 and detections rtol 1e-3 / atol 1e-4,
  the JAX mesh-serving test's (tests/test_multidevice_inference.py).
- fit: two epochs with flip and colour augmentation, per-epoch history at
  the JAX mesh fit test's loop gates (rtol 2.5e-2 / atol 1e-3, then 1e-1 /
  5e-3: Adam amplifies reduction-order noise, and the mining's top-k is
  discrete, tests/test_multichip_train_e2e.py); parameters within 2 * lr a
  step of the one-process run (Adam moves each by at most about lr a step).
Each of the three batch-global reductions has a case where doing it per rank
misses its gate.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ssdseglib_tpu.boxes import Anchors as JaxAnchors
from ssdseglib_tpu.config import AnchorsConfig as JaxAnchorsConfig
from ssdseglib_tpu.config import ModelConfig as JaxModelConfig
from ssdseglib_tpu.config import TrainConfig as JaxTrainConfig
from ssdseglib_tpu.models.builder import SsdSegModel as JaxSsdSegModel
from ssdseglib_tpu.models.builder import TrainableModel
from ssdseglib_tpu.parallel import mesh as jax_mesh
from ssdseglib_tpu.train import Trainer as JaxTrainer
from ssdseglib_tpu.train import TrainState as JaxTrainState

from ssdseglib_torch import layers
from ssdseglib_torch.config import EncodingConfig, ModelConfig
from ssdseglib_torch.data.synthetic import generate_dataset
from ssdseglib_torch.losses import confidence_loss
from ssdseglib_torch.models.builder import SsdSegModel
from ssdseglib_torch.ops.encoding import make_batch_encoder
from ssdseglib_torch.weights import to_flax_variables
from tests import torch_dp_workers as W
from tests.torch_parity import two_torch_threads  # noqa: F401

WORLD = 2
METRIC_GATE = dict(rtol=2e-3, atol=2e-4)
WORKER_SECONDS = 600


def _variables():
    """The port's model at seed 0 with random BatchNorm (statistics and bias
    uniform in [0.5, 1.5], as tests/torch_parity.py draws them)."""
    model = SsdSegModel(ModelConfig(**W.MODEL), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    state = model.state_dict()
    for key, value in state.items():
        if key.endswith(("running_mean", "running_var", "batchnorm.bias")):
            state[key] = torch.tensor(rng.uniform(0.5, 1.5, value.shape).astype(np.float32))
    return state


def _batch(n: int, seed: int = 3):
    samples = generate_dataset(n, image_shape=W.IMAGE_SHAPE, seed=seed)
    enc = EncodingConfig(**W.ENCODING)
    g = enc.max_ground_truth_boxes
    labels = np.zeros((n, g), np.int32)
    boxes = np.zeros((n, g, 4), np.float32)
    valid = np.zeros((n, g), bool)
    for i, s in enumerate(samples):
        k = len(s.labels)
        labels[i, :k], boxes[i, :k], valid[i, :k] = s.labels, s.boxes, True
    enc_labels, enc_boxes = make_batch_encoder(W.anchors(), enc, device="cpu")(
        labels, boxes, valid)
    images = np.stack([s.image for s in samples]).astype(np.float32)
    masks = np.eye(4, dtype=np.float32)[np.stack([s.mask for s in samples])]
    return images, {"output-mask": masks, "output-labels": enc_labels.numpy(),
                    "output-boxes": enc_boxes.numpy()}


def _hnm_inputs(n_anchors: int):
    """(y_true, y_pred) pairs of a global batch of 4: all positives in rank
    0's half; and a tie case, every background loss equal and the
    positives in rank 1's half, where the global ranking keeps rank 0's
    first anchors (the lower global indices)."""
    rng = np.random.default_rng(1)
    shape = (W.BATCH, n_anchors, 4)
    positives = np.zeros(shape, np.float32)
    positives[..., 0] = 1.0
    positives[:2, :10, 0], positives[:2, :10, 1] = 0.0, 1.0
    logits = rng.normal(size=shape) * 2.0
    scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    tie = np.zeros(shape, np.float32)
    tie[..., 0] = 1.0
    tie[2:, :3, 0], tie[2:, :3, 2] = 0.0, 1.0
    return {"rank0_positives": (positives, scores),
            "tie": (tie, np.full(shape, 0.25, np.float32))}


def _suppression_inputs():
    """(mask probabilities (8, 6, 8, 4), labels (8, N, 4)) whose argmax map
    holds class 3 only in images 4-7, rank 1's half."""
    rng = np.random.default_rng(7)
    mask = rng.uniform(0.0, 0.2, (8, 6, 8, 4)).astype(np.float32)
    mask[..., :3] += np.eye(3, dtype=np.float32)[rng.integers(0, 3, (8, 6, 8))]
    mask[4:, 2, 3, 3] = 2.0
    labels = rng.uniform(0.0, 1.0, (8, 20, 4)).astype(np.float32)
    return mask, labels


class Ranks:
    """The spawned ranks (``world`` of them, running ``run``, by default the
    two of this file's workers): started at construction, joined and read at
    the first `results` call."""

    def __init__(self, directory, run=W.run, world=WORLD):
        self.directory, self.world = str(directory), world
        self.context = mp.start_processes(run, args=(world, self.directory), nprocs=world,
                                          join=False, start_method="spawn")
        self._results = None

    def results(self):
        if self._results is None:
            import time

            deadline = time.monotonic() + WORKER_SECONDS
            while not self.context.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks did not finish in {WORKER_SECONDS} s")
            self._results = [torch.load(os.path.join(self.directory, f"rank{r}.pt"),
                                        weights_only=False) for r in range(self.world)]
        return self._results

    def stop(self):
        for process in self.context.processes:
            if process.is_alive():
                process.terminate()
            process.join(timeout=10)


@pytest.fixture(scope="module")
def inputs():
    images, targets = _batch(W.BATCH)
    shifted = images.copy()
    shifted[:2] = shifted[:2] * 0.5
    shifted[2:] = shifted[2:] * 0.5 + 120.0  # the halves' means differ
    return {
        "variables": _variables(),
        "batch": (images, targets),
        "shifted": (shifted, targets),
        "hnm": _hnm_inputs(targets["output-labels"].shape[1]),
        "serve_images": np.random.default_rng(5).uniform(0, 255, (8, 96, 128, 3)).astype(
            np.float32),
        "suppression": _suppression_inputs(),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    directory = tmp_path_factory.mktemp("data_parallel")
    torch.save(inputs, directory / "inputs.pt")
    started = Ranks(directory)
    try:
        yield started
    finally:
        started.stop()


def _worst_relative_norm_error(got, want):
    """max over tensors of |got - want| / max(|want|, 1e-4 * largest |want|)."""
    floor = 1e-4 * max(float(v.norm()) for v in want.values())
    return max((float((got[k] - want[k]).norm()) / max(float(want[k].norm()), floor), k)
               for k in want)


def _assert_replicas_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _assert_step_matches(got, want, gate=METRIC_GATE):
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **gate)
    worst = _worst_relative_norm_error(got["grads"], want["grads"])
    assert worst[0] < 5e-2, worst
    for k, v in want["batch_stats"].items():
        scale = float(v.abs().max())
        np.testing.assert_allclose(got["batch_stats"][k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


def _jax_mesh_step(variables, images, targets):
    """One step of the JAX package on its 2-device mesh from the same weights."""
    cfg = JaxModelConfig(**W.MODEL)
    model = TrainableModel(module=JaxSsdSegModel(cfg=cfg), cfg=cfg)
    trainer = JaxTrainer(model=model,
                         anchors=JaxAnchors.from_config(JaxAnchorsConfig(**W.ANCHORS),
                                                        W.IMAGE_SHAPE),
                         config=JaxTrainConfig(**W.TRAIN))
    flax_variables = to_flax_variables(variables)
    mesh = jax_mesh.make_mesh(jax.devices()[:WORLD])
    state = jax_mesh.replicate(mesh, JaxTrainState.create(
        jax.tree_util.tree_map(jnp.array, flax_variables), trainer.tx))
    _, metrics = trainer.train_step_fn()(state, jax_mesh.shard_batch(mesh, images),
                                         jax_mesh.shard_batch(mesh, targets))
    return {k: float(v) for k, v in metrics.items()}


def test_two_rank_step_matches_the_jax_two_device_mesh(inputs, ranks):
    """Runs first, so that the JAX compile overlaps the ranks' work.  The
    comparison needs a batch on which the mining selects the same anchors in
    both packages: the background losses at the budget's edge (from the
    one-process train-mode forward) must be further apart than the
    packages' forwards (tests/test_torch_train.py)."""
    images, targets = inputs["batch"]
    want = _jax_mesh_step(inputs["variables"], images, targets)
    model = SsdSegModel(ModelConfig(**W.MODEL), torch.Generator().manual_seed(0))
    model.load_state_dict(inputs["variables"])
    with torch.no_grad():
        y_pred = model.train()(torch.from_numpy(images))["output-labels"].numpy()
    y_true = targets["output-labels"]
    ce = -np.sum(y_true * np.log(np.clip(y_pred, 1e-7, 1 - 1e-7)), axis=-1)
    background = np.sort((ce * y_true[..., 0]).reshape(-1))[::-1]
    k = min(int(3.0 * (1.0 - y_true[..., 0]).sum()), int(y_true[..., 0].sum()))
    assert 0 < k < background.size
    assert background[k - 1] - background[k] > 1e-5, (background[k - 1], background[k])
    for result in ranks.results():
        got = result["steps"]["aten"]["metrics"]
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=5e-5, err_msg=key)


def test_helpers_shard_replicate_and_refuse(ranks):
    for rank, result in enumerate(ranks.results()):
        helpers = result["helpers"]
        assert "not divisible by the 2-device mesh 'data' axis" in helpers["divisibility"]
        assert torch.equal(helpers["slice"]["a"], torch.arange(8)[4 * rank:4 * rank + 4])
        assert torch.equal(helpers["slice"]["b"][0], torch.arange(4)[2 * rank:2 * rank + 2])
        replicated = helpers["replicated"]  # rank 0's values on every rank
        assert torch.equal(replicated["f32"], torch.ones(2, 3))
        assert torch.equal(replicated["bf16"], torch.full((5,), 1.5, dtype=torch.bfloat16))
        assert torch.equal(replicated["i64"][0], torch.arange(3))
        assert torch.equal(replicated["nhwc"], torch.zeros(2, 3, 4, 5))
        assert replicated["nhwc"].is_contiguous(memory_format=torch.channels_last)
        assert helpers["placements"] == ("(Shard(dim=0),)", "(Replicate(),)")
        for (entry, kind), refused in helpers["refusals"].items():
            want = "ValueError" if kind == "axes" else "TypeError"
            assert refused == want, (entry, kind, refused)


@pytest.mark.parametrize("route", ["aten", "cuda"])
def test_one_step_on_two_ranks_matches_one_process(inputs, ranks, route):
    """2 ranks x batch 2 against 1 process x batch 4.  The 'cuda' route sets
    the chain, depthwise and weight-gradient gates (on the CPU their plain
    versions), and the chain unit takes its split backward."""
    images, targets = inputs["batch"]
    want = W.one_step(None, inputs["variables"], images, targets)
    first, second = ranks.results()
    for result in (first, second):
        _assert_step_matches(result["steps"][route], want)
    _assert_replicas_equal(first["steps"][route]["params"], second["steps"][route]["params"])
    _assert_replicas_equal(first["steps"][route]["batch_stats"],
                           second["steps"][route]["batch_stats"])
    if route == "cuda":
        for result in (first, second):
            assert result["steps"]["split_calls"] and all(result["steps"]["split_calls"])


def test_global_batchnorm_shows(inputs, ranks):
    """Halves of the batch with different means: the ranks' step equals the
    one-process step, and the same step with per-rank statistics (a naive
    port) misses the gate."""
    images, targets = inputs["shifted"]
    want = W.one_step(None, inputs["variables"], images, targets)
    for result in ranks.results():
        _assert_step_matches(result["global_batchnorm"]["global"], want)
        per_rank = result["global_batchnorm"]["per_rank"]["metrics"]
        assert not np.allclose(per_rank["loss"], want["metrics"]["loss"], **METRIC_GATE)


def test_global_hard_negative_mining_shows(inputs, ranks):
    """All positives in rank 0's half, and equal background losses across the
    rank boundary: the ranks' per-sample losses are the one-process losses;
    a per-rank budget and ranking miss them."""
    first, second = ranks.results()
    for name, (y_true, y_pred) in inputs["hnm"].items():
        want = confidence_loss(torch.from_numpy(y_true), torch.from_numpy(y_pred)).numpy()
        got = np.concatenate([first["hard_negatives"][name, "global"].numpy(),
                              second["hard_negatives"][name, "global"].numpy()])
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        per_rank = np.concatenate([first["hard_negatives"][name, "per_rank"].numpy(),
                                   second["hard_negatives"][name, "per_rank"].numpy()])
        assert not np.allclose(per_rank, want, rtol=1e-3), name


def test_fit_on_two_ranks_matches_one_process(ranks):
    """Two epochs over a TrainDataLoader with flip and colour augmentation,
    and a validation pass over another after each (the eval steps): the
    ranks decode their slices of the same global batches and draw the
    global batch's augmentation, so they follow the one-process run."""
    t = W.trainer()
    state = t.init_state(variables=_variables())
    state, want = t.fit(state, W.loader(), epochs=2, validation_data=W.loader(),
                        log_fn=lambda s: None)
    first, second = ranks.results()
    for result in (first, second):
        got = result["fit"]
        assert got["step"] == state.step == 8
        assert set(got["history"]) == set(want)
        for k in want:
            np.testing.assert_allclose(got["history"][k][0], want[k][0], rtol=2.5e-2,
                                       atol=1e-3, err_msg=k)
            np.testing.assert_allclose(got["history"][k][1], want[k][1], rtol=1e-1,
                                       atol=5e-3, err_msg=k)
        limit = 2.0 * W.TRAIN["learning_rate"] * state.step
        for k, v in state.params.items():
            assert float((got["params"][k] - v).abs().max()) <= limit, k
    np.testing.assert_allclose(first["fit"]["history"]["loss"][0], want["loss"][0], rtol=1e-4)
    _assert_replicas_equal(first["fit"]["params"], second["fit"]["params"])


def test_checkpoint_and_resume_on_the_mesh(ranks):
    """fit with a checkpointer on the mesh: rank 0 writes, alone; a fresh
    trainer resumes on the mesh from the saved step, every rank alike."""
    first, second = ranks.results()
    assert first["fit"]["checkpoint"]["writes"] == [4, 8]
    assert second["fit"]["checkpoint"]["writes"] == []
    for result in (first, second):
        checkpoint = result["fit"]["checkpoint"]
        assert checkpoint["saved"]["step"] == 4 and checkpoint["resumed_step"] == 8
        assert checkpoint["files"] == ["step_00000004.pt", "step_00000008.pt"]
        assert np.isfinite(checkpoint["resumed_loss"])
    _assert_replicas_equal(first["fit"]["checkpoint"]["resumed_params"],
                           second["fit"]["checkpoint"]["resumed_params"])


def test_shufflenet_fit_on_the_mesh(ranks):
    first, second = ranks.results()
    for result in (first, second):
        assert result["fit"]["shufflenet"]["step"] == 4
        assert np.isfinite(result["fit"]["shufflenet"]["loss"])
    _assert_replicas_equal(first["fit"]["shufflenet"]["params"],
                           second["fit"]["shufflenet"]["params"])


@pytest.mark.parametrize("fused", [False, True])
def test_serving_on_two_ranks_matches_one_process(inputs, ranks, fused):
    """2 ranks x batch 4 `predict` against 1 process x batch 8: the whole
    batch on every rank; `__call__` gives the rank's slice; `predict_batched`
    over 6 images at batch 4 (repeat-padded to 8, 4 a rank)."""
    images = inputs["serve_images"]
    single = W.inference_model(inputs["variables"], fused=fused)
    mask, det = single.predict(images)
    batched_mask, batched_det = single.predict_batched(images[:6], batch=4)
    for rank, result in enumerate(ranks.results()):
        got_mask, got_det = result["serving"]["predict", fused]
        np.testing.assert_allclose(got_mask, mask, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_det, det, rtol=1e-3, atol=1e-4)
        got_mask, got_det = result["serving"]["batched", fused]
        np.testing.assert_allclose(got_mask, batched_mask, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_det, batched_det, rtol=1e-3, atol=1e-4)
        call_mask, call_det = result["serving"]["call", fused]
        assert call_mask.shape[0] == call_det.shape[0] == 4
        np.testing.assert_allclose(call_mask.numpy(), mask[4 * rank:4 * rank + 4], rtol=1e-4,
                                   atol=1e-5)
    if not fused:  # `update_variables` loads rank 0's weights on every rank
        for result in ranks.results():
            got_mask, got_det = result["serving"]["updated"]
            np.testing.assert_allclose(got_mask, mask, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got_det, det, rtol=1e-3, atol=1e-4)


def test_quantized_serving_on_two_ranks_matches_one_process(inputs, ranks):
    """``quantize_pointwise`` on the mesh: each rank calibrates on the whole
    calibration batch with the replicated weights, so the two ranks hold the
    same int8 tables bit for bit, those of one process (its amaxes within
    f32 noise), and `predict` gives one process's outputs."""
    images = inputs["serve_images"]
    single = W.inference_model(inputs["variables"], fused=True, quantize_pointwise=True,
                               calibration_images=images)
    mask, det = single.predict(images)
    want = W.int8_tables(single)
    (first, first_tables), (second, second_tables) = (
        result["serving"]["quantized"] for result in ranks.results())
    assert len(want) == 2 and set(first_tables) == set(second_tables) == set(want)
    for name, tables in want.items():
        for a, b, c in zip(first_tables[name], second_tables[name], tables):
            assert torch.equal(a, b), name
            torch.testing.assert_close(a, c, rtol=1e-5, atol=0, msg=name)
    for got_mask, got_det in (first, second):
        np.testing.assert_allclose(got_mask, mask, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_det, det, rtol=1e-3, atol=1e-4)


def test_segmentation_suppression_is_global_on_the_mesh(inputs, ranks):
    """Class 3 is present in rank 1's images only: on the mesh rank 0 keeps
    its class-3 probabilities, as one process does; per rank it zeroes them."""
    mask, labels = (torch.from_numpy(a) for a in inputs["suppression"])
    want = layers.SegmentationSuppression()(mask, labels)
    assert float(want[:4, :, 3].abs().sum()) > 0
    first, second = ranks.results()
    got = torch.cat([first["serving"]["gated"], second["serving"]["gated"]])
    assert torch.equal(got, want)
    per_rank = torch.cat([first["serving"]["gated_per_rank"],
                          second["serving"]["gated_per_rank"]])
    assert not torch.allclose(per_rank, want, rtol=1e-3)


def test_learning_run_example_on_the_mesh(ranks, tmp_path):
    """`examples/train_multitask.run(mesh=)`, what ``--data-parallel`` runs
    under torchrun, at 96x128 on 8 samples in batches of 4: the one
    process's epoch at the fit gate, and both ranks' evaluations alike."""
    from ssdseglib_torch.examples import train_multitask

    want = train_multitask.run(**W.EXAMPLE, device="cpu", workdir=str(tmp_path),
                               log_fn=lambda line: None)
    first, second = (r["example"] for r in ranks.results())
    for got in (first, second):
        assert got["world_size"] == 2 and got["steps_per_epoch"] == want["steps_per_epoch"] == 2
        np.testing.assert_allclose(got["first_loss"], want["first_loss"], rtol=2.5e-2)
    assert first["metrics"] == second["metrics"]


def test_host_batcher_shards_walk_the_global_batches():
    """Each rank's batcher walks the one process's shuffled batches and
    decodes its contiguous slice; a last partial batch that does not divide
    over the ranks is refused with `shard_batch`'s error."""
    from ssdseglib_torch.data.pipeline import HostBatcher

    samples = generate_dataset(10, image_shape=(16, 24), seed=1)

    def batches(**kwargs):
        return [b[0] for b in HostBatcher(samples, 4, seed=5, num_workers=1,
                                          use_sample_cache=False, **kwargs)]

    for drop in (True, False):
        whole = batches(drop_remainder=drop)
        halves = [batches(drop_remainder=drop, shard=(r, 2)) for r in range(2)]
        assert len(whole) == len(halves[0]) == len(halves[1]) == (2 if drop else 3)
        for w, a, b in zip(whole, *halves):
            np.testing.assert_array_equal(np.concatenate([a, b]), w)
    with pytest.raises(ValueError, match="not divisible by the 3-device mesh 'data' axis"):
        batches(drop_remainder=False, shard=(0, 3))


def test_export_refuses_a_mesh_model(ranks):
    for result in ranks.results():
        assert "build the InferenceModel without mesh=" in result["serving"]["export"]
