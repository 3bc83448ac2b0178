"""The port's Trainer against ssdseglib_tpu.train.Trainer on the CPU, at the
small configuration of the JAX package's own training tests (96x128, batch
8): the same weights (bridged through ssdseglib_torch.weights) and the same
batch (synthetic scenes, made with NumPy from a seed) go through both.

Tolerances, all f32 on the CPU:
- loss and metrics of a step: rtol 5e-5.  The mask loss is a SUM over
  12288 pixels x 4 classes per sample taken in f32 in another order by each
  framework (measured here: 3e-6 to 9e-6 relative, depending on the number
  of threads).
- gradients: the metric and limit of the JAX package's own cross-framework
  gradient test (tests/test_grad_parity.py): per tensor, the norm of the
  difference over max(norm, 1e-4 * the largest tensor norm) stays below
  5e-2.  The backward of ~60 stacked train-mode BatchNorms cancels heavily:
  measured here, the port's f32 gradients are 2.8e-2 from the port's own
  f64 gradients, the JAX package's f32 gradients 2.8e-2 from them too, and
  the two f32 sets 2.3e-2 from each other.  So the f32 comparison cannot be
  tighter, and `test_one_step_gradients_within_f32_noise_of_f64` holds the
  JAX gradients to the port's f64 ones as closely as the port's own f32.
- running statistics after a step: rtol 1e-4, atol 1e-6 (the library's
  two-pass batch variance against Flax's E[x^2] - E[x]^2, times the
  momentum 0.01).
- parameters after the Adam step: Adam's first update is lr * g / (|g| +
  1e-8), the SIGN of the gradient for all but vanishing ones, so an element
  whose gradient is within the noise above moves by lr in either direction.
  Every element is held to 2 * lr; of the elements whose gradient is above a
  fifth of their tensor's rms (in tensors that are not noise as a whole),
  which are close to half of the network, all but one in a thousand to
  2e-2 * lr.  `adam_update` itself is
  held to optax on identical gradients at rtol 1e-6.
"""

import contextlib
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssdseglib_tpu.boxes import Anchors as JaxAnchors
from ssdseglib_tpu.config import AnchorsConfig, ModelConfig
from ssdseglib_tpu.config import TrainConfig as JaxTrainConfig
from ssdseglib_tpu.models.builder import SsdSegModel as JaxSsdSegModel
from ssdseglib_tpu.models.builder import TrainableModel
from ssdseglib_tpu.train import Trainer as JaxTrainer
from ssdseglib_tpu.train import TrainState as JaxTrainState

from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import EncodingConfig, TrainConfig
from ssdseglib_torch.config import ModelConfig as PortModelConfig
from ssdseglib_torch.data.synthetic import generate_dataset
from ssdseglib_torch.models.builder import SsdSegModel
from ssdseglib_torch.ops.encoding import make_batch_encoder
from ssdseglib_torch.train import Trainer, adam_update, lr_schedule_fn
from ssdseglib_torch.weights import (
    from_flax_variables,
    moments_from_flax,
    moments_to_flax,
    to_flax_variables,
)
from tests.torch_parity import randomize_batchnorm

IMAGE_SHAPE = (96, 128)
BATCH = 8
ANCHORS_CFG = dict(
    feature_maps_shapes=((6, 8), (3, 4), (2, 2), (1, 1)),
    feature_maps_aspect_ratios=((1.0, 2.0, 0.5),) * 4,
    boxes_scales=(0.2, 0.9),
    centers_padding_from_borders=(0.05, 0.05, 0.05, 0.05),
    additional_square_box=True,
)
MODEL_CFG = dict(
    input_image_shape=(96, 128, 3),
    number_of_classes=4,
    boxes_per_point=(4, 4, 4, 4),
    backbone="mobilenetv2",
    segmentation_dilation_rates=(3, 6, 12),
)
ENC_CFG = EncodingConfig(num_classes=4, image_shape=IMAGE_SHAPE, iou_threshold=0.35,
                         max_ground_truth_boxes=16)
TRAIN_CFG = dict(batch_size=BATCH, learning_rate=3e-4, epochs=1)
LR = TRAIN_CFG["learning_rate"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.array(v, dtype=np.float32)  # a copy, not a view of live state
    return out


@pytest.fixture(scope="module")
def batch():
    """(images (8, 96, 128, 3) f32, targets) as NumPy, encoded by the port."""
    samples = generate_dataset(BATCH, image_shape=IMAGE_SHAPE, seed=3)
    g = ENC_CFG.max_ground_truth_boxes
    labels = np.zeros((BATCH, g), np.int32)
    boxes = np.zeros((BATCH, g, 4), np.float32)
    valid = np.zeros((BATCH, g), bool)
    for i, s in enumerate(samples):
        n = len(s.labels)
        labels[i, :n], boxes[i, :n], valid[i, :n] = s.labels, s.boxes, True
    anchors = Anchors.from_config(AnchorsConfig(**ANCHORS_CFG), IMAGE_SHAPE)
    enc_labels, enc_boxes = make_batch_encoder(anchors, ENC_CFG, device="cpu")(
        labels, boxes, valid)
    images = np.stack([s.image for s in samples]).astype(np.float32)
    masks = np.eye(4, dtype=np.float32)[np.stack([s.mask for s in samples])]
    return images, {"output-mask": masks, "output-labels": enc_labels.numpy(),
                    "output-boxes": enc_boxes.numpy()}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX Trainer with its compiled step, and the start variables."""
    cfg = ModelConfig(**MODEL_CFG)
    anchors = JaxAnchors.from_config(AnchorsConfig(**ANCHORS_CFG), IMAGE_SHAPE)
    model = TrainableModel(module=JaxSsdSegModel(cfg=cfg), cfg=cfg)
    trainer = JaxTrainer(model=model, anchors=anchors, config=JaxTrainConfig(**TRAIN_CFG))
    variables = randomize_batchnorm(jax.device_get(model.init(jax.random.key(0))))
    return trainer, variables


def _jax_state(trainer, variables):
    # fresh buffers: the JAX step donates its state
    return JaxTrainState.create(jax.tree_util.tree_map(jnp.array, variables), trainer.tx)


def _port_trainer(**overrides):
    anchors = Anchors.from_config(AnchorsConfig(**ANCHORS_CFG), IMAGE_SHAPE)
    model = SsdSegModel(PortModelConfig(**MODEL_CFG), torch.Generator().manual_seed(0))
    return Trainer(model=model, anchors=anchors,
                   config=TrainConfig(**{**TRAIN_CFG, **overrides}), device="cpu")


@pytest.fixture(scope="module")
def steps(jax_side, batch):
    """Five steps on one batch in both packages: per-step metrics, and the
    whole state of each after the first step."""
    jax_trainer, variables = jax_side
    images, targets = batch
    step = jax_trainer.train_step_fn()
    state = _jax_state(jax_trainer, variables)
    jax_metrics, jax_first = [], None
    for i in range(5):
        state, m = step(state, images, targets)
        jax_metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            jax_first = jax.device_get(state)

    trainer = _port_trainer()
    pstate = trainer.init_state(variables=from_flax_variables(variables))
    port_metrics, port_first = [], None
    for i in range(5):
        pstate, m = trainer.train_step(pstate, images, targets)
        port_metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            port_first = {
                "variables": _flat(to_flax_variables(pstate.variables())),
                "mu": _flat(moments_to_flax(pstate.opt_state.mu)),
                "nu": _flat(moments_to_flax(pstate.opt_state.nu)),
                "step": pstate.step,
            }
    return jax_metrics, jax_first, port_metrics, port_first, variables


def test_hnm_budget_edge_has_no_tie(jax_side, batch):
    """The one-step comparison needs a batch on which hard-negative mining
    selects the same anchors in both packages: the background losses at the
    budget's edge must be further apart than the packages' forwards."""
    from ssdseglib_tpu import losses as jax_losses

    trainer, variables = jax_side
    images, targets = batch
    outputs, _ = trainer.model.apply(variables, jnp.asarray(images), train=True)
    y_true, y_pred = targets["output-labels"], np.asarray(outputs["output-labels"])
    ce = -np.sum(y_true * np.log(np.clip(y_pred, 1e-7, 1 - 1e-7)), axis=-1)
    background = np.sort((ce * y_true[..., 0]).reshape(-1))[::-1]
    k = min(int(3.0 * (1.0 - y_true[..., 0]).sum()), int(y_true[..., 0].sum()))
    assert 0 < k < background.size
    assert background[k - 1] - background[k] > 1e-5, (background[k - 1], background[k])
    assert np.isfinite(np.asarray(
        jax_losses.confidence_loss(jnp.asarray(y_true), jnp.asarray(y_pred)))).all()


def test_one_step_loss_and_metrics_match_jax(steps):
    jax_metrics, _, port_metrics, _, _ = steps
    assert set(port_metrics[0]) == set(jax_metrics[0])
    for k, want in jax_metrics[0].items():
        np.testing.assert_allclose(port_metrics[0][k], want, rtol=5e-5, err_msg=k)


def _worst_relative_norm_error(got, want):
    """max over tensors of |got - want| / max(|want|, 1e-4 * largest |want|)."""
    floor = 1e-4 * max(np.linalg.norm(v) for v in want.values())
    return max(
        (float(np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), floor)), k)
        for k in want
    )


def test_one_step_every_gradient_matches_jax(steps):
    """Adam's moments after one step are (1 - b1) * g and (1 - b2) * g^2:
    every gradient of the step, through `train_step_fn` alone."""
    _, jax_first, _, port_first, _ = steps
    jax_mu = _flat(jax.device_get(jax_first.opt_state[0].mu))
    assert set(jax_mu) == set(port_first["mu"]) and len(jax_mu) > 200
    worst = _worst_relative_norm_error(port_first["mu"], jax_mu)
    assert worst[0] < 5e-2, worst
    jax_nu = _flat(jax.device_get(jax_first.opt_state[0].nu))
    worst = _worst_relative_norm_error(port_first["nu"], jax_nu)
    assert worst[0] < 1e-1, worst  # squares: twice the relative error


def test_one_step_gradients_within_f32_noise_of_f64(jax_side, batch, steps):
    """The port's network in f64 gives the gradient both f32 runs
    approximate: the JAX package's f32 gradients must be as close to it as
    the port's own f32 gradients are (within a factor 2), and both within
    the 5e-2 of the f32 comparison."""
    from torch.func import functional_call

    _, jax_first, _, port_first, variables = steps
    images, targets = batch
    trainer = _port_trainer()
    state = trainer.init_state(variables=from_flax_variables(variables))
    net = trainer._net.double().train()
    leaves = {k: v.double().requires_grad_() for k, v in state.params.items()}
    stats = {k: v.double() for k, v in state.batch_stats.items()}
    outputs = functional_call(net, {**leaves, **stats},
                              (torch.from_numpy(images).double(),))
    total, _ = trainer._losses_and_metrics(
        outputs, {k: torch.from_numpy(v).double() for k, v in targets.items()})
    names = list(leaves)
    grads = torch.autograd.grad(total, [leaves[k] for k in names])
    exact = _flat(moments_to_flax({k: 0.1 * g.float() for k, g in zip(names, grads)}))
    jax_mu = _flat(jax.device_get(jax_first.opt_state[0].mu))
    port_err = _worst_relative_norm_error(port_first["mu"], exact)[0]
    jax_err = _worst_relative_norm_error(jax_mu, exact)[0]
    assert port_err < 5e-2 and jax_err < 5e-2, (port_err, jax_err)
    assert jax_err < 2.0 * port_err + 1e-3, (port_err, jax_err)


def test_one_step_every_parameter_and_statistic_matches_jax(steps):
    _, jax_first, _, port_first, start = steps
    assert port_first["step"] == int(jax_first.step) == 1
    jax_vars = _flat({"params": jax_first.params, "batch_stats": jax_first.batch_stats})
    grads = _flat(jax.device_get(jax_first.opt_state[0].mu))
    largest_norm = max(np.linalg.norm(g) for g in grads.values())
    before = _flat(start)
    assert set(jax_vars) == set(port_first["variables"])
    solid_count = total_count = flipped = 0
    for name, want in jax_vars.items():
        got = port_first["variables"][name]
        if name.startswith("batch_stats/"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=name)
            assert np.abs(want - before[name]).max() > 0, name  # the step moved it
            continue
        diff = np.abs(got - want)
        assert diff.max() <= 2.0 * LR * (1 + 1e-3), (name, diff.max())
        g = grads[name[len("params/"):]]
        total_count += g.size
        if np.linalg.norm(g) < 1e-3 * largest_norm:
            continue  # a tensor whose gradient is rounding noise as a whole
        solid = np.abs(g) > 0.2 * np.sqrt(np.mean(g * g))
        solid_count += int(solid.sum())
        flipped += int((diff[solid] > 2e-2 * LR).sum())
        # and the step did move the parameters it is compared on
        assert np.abs(want - before[name])[solid].min() > 0.5 * LR, name
    assert solid_count > 0.4 * total_count, (solid_count, total_count)
    assert flipped <= 1e-3 * solid_count, (flipped, solid_count)


def test_five_step_loss_trajectory_matches_jax(steps):
    """Five Adam steps on one batch.  Parameters with vanishing gradients
    drift apart by up to lr a step (see the module docstring), so the
    trajectories are held to rtol 5e-3 at each step (measured: 1e-3), and
    both must fall."""
    jax_metrics, _, port_metrics, _, _ = steps
    jax_loss = [m["loss"] for m in jax_metrics]
    port_loss = [m["loss"] for m in port_metrics]
    np.testing.assert_allclose(port_loss, jax_loss, rtol=5e-3)
    assert port_loss[-1] < port_loss[0] and jax_loss[-1] < jax_loss[0]


def test_running_variance_is_flax_biased_variance(jax_side, batch):
    """One train-mode forward: `running_var` moves by the BIASED batch
    variance, as Flax's does (torch's own update uses the unbiased one).
    On the smallest maps a channel has n = 8 values per statistic, so the
    two differ by a factor 8/7 in the increment; rtol 1e-4 on the updated
    statistic tells them apart wherever the increment is above 1e-3."""
    jax_trainer, variables = jax_side
    images, _ = batch
    _, new_stats = jax_trainer.model.apply(variables, jnp.asarray(images), train=True)
    want = _flat({"batch_stats": jax.device_get(new_stats)})

    model = SsdSegModel(PortModelConfig(**MODEL_CFG), torch.Generator().manual_seed(0))
    model.load_state_dict(from_flax_variables(variables))
    model.train()
    assert all(m.training for m in model.modules())
    with torch.no_grad():
        model(torch.from_numpy(images))
    got = _flat({"batch_stats": to_flax_variables(model.state_dict())["batch_stats"]})
    before = _flat({"batch_stats": variables["batch_stats"]})
    assert set(got) == set(want)
    unbiased_would_fail = 0
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        if name.endswith("/var") and "block18" in name:  # 1x1 maps: n = 8
            increment = (want[name] - 0.99 * before[name])
            unbiased = 0.99 * before[name] + increment * 8.0 / 7.0
            unbiased_would_fail += int(
                not np.allclose(unbiased, want[name], rtol=1e-4, atol=1e-6))
    assert unbiased_would_fail > 0


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adam_update_matches_optax(mu_dtype):
    """`adam_update` against optax.adam on identical gradients, three steps:
    parameters rtol 1e-6; moments rtol 1e-6 in f32 and one bf16 ulp (8e-3)
    for a bf16 first moment."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3, 3, 3), (7,), (4, 1, 3, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    schedule = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 10, 1e-4)
    tx = optax.adam(schedule, mu_dtype=jnp.dtype(mu_dtype))
    jp = [jnp.asarray(p) for p in params]
    opt = tx.init(jp)

    cfg = TrainConfig(learning_rate=1e-2, lr_schedule="warmup_cosine", lr_warmup_steps=1,
                      lr_total_steps=10, lr_final=1e-4)
    lr = lr_schedule_fn(cfg)
    tp = [torch.tensor(p) for p in params]
    mu = [torch.zeros_like(p, dtype=getattr(torch, mu_dtype)) for p in tp]
    nu = [torch.zeros_like(p) for p in tp]
    for count, g in enumerate(grads):
        updates, opt = tx.update([jnp.asarray(x) for x in g], opt, jp)
        jp = optax.apply_updates(jp, updates)
        adam_update(tp, [torch.tensor(x) for x in g], mu, nu, count, lr(count))
        mu_tol = 1e-6 if mu_dtype == "float32" else 8e-3
        for a, b, m, jm, v, jv in zip(tp, jp, mu, opt[0].mu, nu, opt[0].nu):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(m.float().numpy(), np.asarray(jm, np.float32),
                                       rtol=mu_tol, atol=1e-30)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-30)
    assert mu[0].dtype == getattr(torch, mu_dtype)


def test_optax_moments_cross_the_bridge_both_ways(steps):
    """optax's mu tree -> the port's per-parameter tensors -> the same tree,
    bit for bit; a bf16 moment comes out as f32 NumPy of the same values."""
    _, jax_first, _, _, _ = steps
    mu = jax.device_get(jax_first.opt_state[0].mu)
    tensors = moments_from_flax(mu)
    assert set(tensors) == set(_port_trainer()._param_names)
    back = _flat(moments_to_flax(tensors))
    for name, want in _flat(mu).items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    low = moments_to_flax({k: v.bfloat16() for k, v in tensors.items()})
    for name, got in _flat(low).items():
        key = name.replace("/", ".").replace("kernel", "weight").replace("scale", "weight")
        np.testing.assert_array_equal(got, tensors[key].bfloat16().float().numpy().transpose(
            2, 3, 1, 0) if got.ndim == 4 else tensors[key].bfloat16().float().numpy())


def test_warmup_cosine_matches_optax_and_rejects_missing_total():
    cfg = TrainConfig(learning_rate=3e-4, lr_schedule="warmup_cosine", lr_warmup_steps=4,
                      lr_total_steps=50, lr_final=1e-6)
    ours = lr_schedule_fn(cfg)
    theirs = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 4, 50, 1e-6)
    assert ours(0) == 0.0  # the first step of a warm-up trains with lr 0
    for count in (0, 1, 3, 4, 5, 27, 49, 50, 51, 1000):
        # optax takes the cosine in f32: near the end 1 + cos cancels
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=2e-5,
                                   atol=1e-11, err_msg=str(count))
    constant = lr_schedule_fn(TrainConfig(learning_rate=1e-3))
    assert constant(0) == constant(10 ** 6) == 1e-3
    with pytest.raises(ValueError, match="lr_total_steps"):
        _port_trainer(lr_schedule="warmup_cosine")
    with pytest.raises(ValueError, match="lr_schedule"):
        _port_trainer(lr_schedule="bogus")


def test_trainer_rejects_bad_config():
    with pytest.raises(ValueError, match="streaming_metrics"):
        _port_trainer(streaming_metrics="bogus")
    with pytest.raises(ValueError, match="mask loss"):
        _port_trainer(mask_loss="bogus")
    with pytest.raises(ValueError, match="compute_dtype"):
        _port_trainer(compute_dtype="float16")


def test_loss_only_streaming_metrics(batch):
    images, targets = batch
    got = {}
    for mode in ("full", "loss_only"):
        trainer = _port_trainer(streaming_metrics=mode)
        state = trainer.init_state(torch.Generator().manual_seed(5))
        got[mode] = trainer.train_step(state, images, targets)[1]
    assert set(got["loss_only"]) == {"loss", "loss/mask", "loss/labels", "loss/boxes"}
    assert {"iou/mask", "iou/boxes", "accuracy/labels"} <= set(got["full"])
    for k, v in got["loss_only"].items():
        np.testing.assert_allclose(float(v), float(got["full"][k]), rtol=1e-6)


def test_bf16_compute_bf16_mu_and_remat_train_step(batch):
    """Mixed precision + bf16 first moment + rematerialised forward: the step
    runs, keeps f32 masters and statistics, stores mu in bf16 and drives the
    loss down; the running statistics are updated once per step although the
    forward runs twice."""
    images, targets = batch
    trainer = _port_trainer(compute_dtype="bfloat16", adam_mu_dtype="bfloat16", remat=True)
    state = trainer.init_state(torch.Generator().manual_seed(5))
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state.mu.values())
    assert all(v.dtype == torch.float32 for v in state.opt_state.nu.values())
    name = "backbone.backbone-block0-expand.batchnorm.running_mean"
    before = state.batch_stats[name].clone()

    _, _, once = trainer.loss_and_grads(state, images, targets)
    state, first = trainer.train_step(state, images, targets)
    torch.testing.assert_close(state.batch_stats[name], once[name], rtol=0, atol=0)
    assert not torch.equal(state.batch_stats[name], before)
    for _ in range(10):
        state, last = trainer.train_step(state, images, targets)
    assert np.isfinite(float(last["loss"]))
    assert float(last["loss"]) < float(first["loss"])
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(s.dtype == torch.float32 for s in state.batch_stats.values())


def test_bf16_running_statistics_pass_through_bf16_like_flax(jax_side):
    """Mixed precision in the JAX package casts the running statistics to
    bf16, and Flax then updates them; compiled, as the JAX package's step
    runs it, the update is f32(bf16(0.99)) * f32(bf16(old)) + 0.01 * batch,
    with bf16(0.99) = 0.98828125 (XLA keeps the product in f32, where Flax
    run op by op also rounds it to bf16).  `Trainer._compute_variables`
    prepares the working statistics and the port's BatchNorm updates them.
    Held here on ONE BatchNorm and an identical bf16 activation (a whole bf16
    network on the CPU differs between XLA and oneDNN by far more than these
    roundings): updated statistics rtol 1e-5 / atol 1e-6 (the library's
    two-pass variance against Flax's E[x^2] - E[x]^2, times 0.01), output one
    bf16 ulp.  An update without the rounding of `old`, or with the product
    rounded as well, is off by up to 2^-8 * |old| ~ 4e-3 and must fail that
    tolerance."""
    import flax.linen as nn
    from torch.func import functional_call

    _, variables = jax_side
    layer = ("backbone", "backbone-block0-expand", "batchnorm")
    params = variables["params"][layer[0]][layer[1]][layer[2]]
    stats = variables["batch_stats"][layer[0]][layer[1]][layer[2]]
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=(8, 6, 8, 32)) * 2.0 + 0.5, jnp.bfloat16)
    cast = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)

    def flax_update(p, s, x):
        return nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3).apply(
            {"params": p, "batch_stats": s}, x, mutable=["batch_stats"])

    y_want, mutated = jax.jit(flax_update)(cast(params), cast(stats), x)
    assert y_want.dtype == jnp.bfloat16
    _, op_by_op = flax_update(cast(params), cast(stats), x)

    trainer = _port_trainer(compute_dtype="bfloat16")
    state = trainer.init_state(variables=from_flax_variables(variables))
    prefix = ".".join(layer)
    port_params, port_stats = trainer._compute_variables(state.params, state.batch_stats)
    module = trainer._net[layer[0]][layer[1]].batchnorm.train()
    working = {k[len(prefix) + 1:]: v for k, v in {**port_params, **port_stats}.items()
               if k.startswith(prefix + ".")}
    x_port = torch.tensor(np.asarray(x, np.float32)).bfloat16().permute(0, 3, 1, 2)
    y_got = functional_call(module, working, (x_port,)).detach()
    assert y_got.dtype == torch.bfloat16
    np.testing.assert_allclose(y_got.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_want, np.float32), rtol=8e-3, atol=8e-3)
    tol = dict(rtol=1e-5, atol=1e-6)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        want = np.asarray(mutated["batch_stats"][theirs], np.float32)
        got = working[ours].detach().numpy()
        np.testing.assert_allclose(got, want, err_msg=ours, **tol)
        old = np.asarray(stats[theirs], np.float32)
        kept = torch.tensor(old).bfloat16().float().numpy() * 0.98828125
        assert not np.allclose(got + (0.98828125 * old - kept), want, **tol), ours
        rounded = np.asarray(op_by_op["batch_stats"][theirs], np.float32)
        assert not np.allclose(rounded, want, **tol), ours


def test_recalibrate_batch_stats_matches_jax(jax_side, batch):
    """PreciseBN over three copies of one batch from the same weights in both
    packages: rtol 1e-4 / atol 5e-5.  The JAX package recovers a batch's
    statistics from the EMA by (new - 0.99 * old) / 0.01, which loses about
    two digits (its own test allows atol 1e-5 on smaller statistics); the
    port reads them directly."""
    jax_trainer, variables = jax_side
    images, targets = batch
    recal = jax_trainer.recalibrate_batch_stats(
        _jax_state(jax_trainer, variables), [(images, targets)] * 3, max_batches=3)
    want = _flat({"batch_stats": jax.device_get(recal.batch_stats)})

    trainer = _port_trainer()
    state = trainer.init_state(variables=from_flax_variables(variables))
    ema = {k: v.clone() for k, v in state.batch_stats.items()}
    momentum = trainer._net["backbone"]["backbone-block0-expand"].batchnorm.momentum
    state = trainer.recalibrate_batch_stats(state, [(images, targets)] * 5, max_batches=3)
    got = _flat({"batch_stats": to_flax_variables(state.batch_stats)["batch_stats"]})
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=5e-5,
                                   err_msg=name)
    moved = max(float((state.batch_stats[k] - ema[k]).abs().max()) for k in ema)
    assert moved > 1e-3
    # the momentum that the recalibration sets to 1 is back
    assert trainer._net["backbone"]["backbone-block0-expand"].batchnorm.momentum == momentum
    assert trainer.recalibrate_batch_stats(state, [], max_batches=3) is state


@contextlib.contextmanager
def _one_rank_mesh(names=("spatial", "data")):
    """A DeviceMesh of one CPU rank with axes ``names`` (by default neither
    ('data',) nor ('data', 'spatial')), on a group of this process alone
    that is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    with tempfile.TemporaryDirectory() as directory:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(directory, "s"), 1),
                                rank=0, world_size=1)
        try:
            yield DeviceMesh("cpu", [[0]], mesh_dim_names=names)
        finally:
            dist.destroy_process_group()


def test_fit_history_keys_and_refusals(jax_side, batch):
    images, targets = batch
    trainer = _port_trainer()
    state = trainer.init_state(torch.Generator().manual_seed(1))
    logs = []
    state, history = trainer.fit(
        state, [(images, targets)] * 2, epochs=2, validation_data=lambda: [(images, targets)],
        log_fn=logs.append,
    )
    keys = {"loss", "loss/mask", "loss/labels", "loss/boxes", "iou/mask", "iou/boxes",
            "accuracy/labels"}
    assert set(history) == keys | {f"val_{k}" for k in keys}
    assert all(len(v) == 2 for v in history.values())
    assert state.step == 4 and len(logs) == 2 and "val_loss=" in logs[0]
    state, history = trainer.fit(state, [(images, targets)] * 2, epochs=1,
                                 steps_per_epoch=1, log_fn=logs.append)
    assert state.step == 5

    class Loader:
        transform = staticmethod(lambda *a: a)

        def iter_raw(self):
            return iter(())

    # a mesh that is no DeviceMesh is refused, and so is one whose axes are
    # neither ('data',) nor ('data', 'spatial'); a world-size-1 gloo group of
    # this process holds the mesh
    with pytest.raises(TypeError):
        trainer.fit(state, [(images, targets)], epochs=1, mesh=object())
    with _one_rank_mesh() as mesh:
        with pytest.raises(ValueError, match="spatial"):
            trainer.fit(state, [(images, targets)], epochs=1, mesh=mesh)
    # resume without a checkpointer is ignored, as in the JAX package; a
    # loader with a device-side transform runs through the fused steps (this
    # one yields no batch: no step, no history)
    state, history = trainer.fit(state, [(images, targets)], epochs=1, resume=True,
                                 log_fn=logs.append)
    assert state.step == 6
    state, history = trainer.fit(state, Loader(), epochs=1, log_fn=logs.append)
    assert state.step == 6 and history == {}


def test_entry_points_default_to_the_card():
    """`Trainer`, `get_model_for_training`, `get_model_for_inference` and
    `make_fused_forward` run on the card unless the caller asks for the CPU:
    the default is 'cuda',
    and without a card the call raises instead of moving to the CPU."""
    import inspect

    from ssdseglib_torch.models.builder import InferenceModel, _BuilderBase
    from ssdseglib_torch.models.fused_inference import make_fused_forward

    for fn in (_BuilderBase.get_model_for_training, _BuilderBase.get_model_for_inference,
               InferenceModel.__init__, make_batch_encoder, make_fused_forward):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert {f.name: f.default for f in dataclasses.fields(Trainer)}["device"] == "cuda"
    anchors = Anchors.from_config(AnchorsConfig(**ANCHORS_CFG), IMAGE_SHAPE)
    model = SsdSegModel(PortModelConfig(**MODEL_CFG), torch.Generator().manual_seed(0))
    if torch.cuda.is_available():
        trainer = Trainer(model=model, anchors=anchors, config=TrainConfig(**TRAIN_CFG))
        assert trainer.init_state().params["heads.boxes1.sepconv.batchnorm.weight"].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            Trainer(model=model, anchors=anchors, config=TrainConfig(**TRAIN_CFG))
