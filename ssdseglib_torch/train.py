"""Training: state, train/eval steps, fit loop (PyTorch), counterpart of
ssdseglib_tpu/train.py.

- one `train_step` (forward + 3 losses + hand-written Adam + BatchNorm
  statistics) that runs eagerly on the trainer's device and never waits for
  it: the metrics come back as 0-d device tensors
- Keras loss semantics: each output's per-sample loss is batch-averaged and
  combined with `loss_weights` (total = sum_i w_i * mean_i)
- Adam equal to ``optax.adam(lr, mu_dtype=...)``, the learning rate read at
  the count before the increment
- mixed precision as the JAX package does it (not autocast): the f32 master
  parameters AND the running statistics pass through ``compute_dtype``, the
  whole network runs in it, outputs and new statistics come back f32, the
  losses are f32 and the gradients reach the f32 masters

`TrainState` is updated IN PLACE by `train_step` (the JAX package donates
its state to the step, so there too the old state is gone after the call).

Not ported yet, and refused by `fit` rather than ignored: ``mesh`` (data
parallelism), ``checkpointer`` / ``resume``, and loaders that expose a raw
iterator plus a device-side transform (the transform-fused steps).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ssdseglib_torch import losses as losses_lib
from ssdseglib_torch import metrics as metrics_lib
from ssdseglib_torch.boxes import Anchors
from ssdseglib_torch.config import TrainConfig
from ssdseglib_torch.models.blocks import BN_MOMENTUM
from ssdseglib_torch.models.builder import SsdSegModel

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam defaults
_STATS = ("running_mean", "running_var")


@dataclasses.dataclass
class AdamState:
    """First and second moments keyed like the parameters; ``mu`` is stored
    in ``adam_mu_dtype``, ``nu`` in f32."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Step count, f32 master parameters, BatchNorm running statistics and
    optimizer state, keyed by the model's ``state_dict`` names."""

    step: int
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: AdamState

    def variables(self) -> Dict[str, torch.Tensor]:
        """Parameters and statistics as one ``state_dict``-shaped mapping."""
        return {**self.params, **self.batch_stats}


def lr_schedule_fn(cfg: TrainConfig) -> Callable[[int], float]:
    """count -> learning rate.  'constant', or 'warmup_cosine' equal to
    ``optax.warmup_cosine_decay_schedule(0, lr, warmup, total, final)``."""
    if cfg.lr_schedule == "constant":
        return lambda count: cfg.learning_rate
    if cfg.lr_schedule != "warmup_cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if not cfg.lr_total_steps:
        raise ValueError("warmup_cosine needs lr_total_steps")
    peak, warmup = cfg.learning_rate, cfg.lr_warmup_steps
    decay_steps = cfg.lr_total_steps - warmup
    if not decay_steps > 0:
        raise ValueError(
            f"warmup_cosine needs lr_total_steps > lr_warmup_steps, got "
            f"{cfg.lr_total_steps} and {warmup}"
        )
    alpha = 0.0 if peak == 0.0 else cfg.lr_final / peak

    def schedule(count: int) -> float:
        if count < warmup:
            return (0.0 - peak) * (1.0 - count / warmup) + peak
        t = min(count - warmup, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                mu: List[torch.Tensor], nu: List[torch.Tensor], count: int,
                lr: float) -> None:
    """One ``optax.adam`` step, in place: ``count`` is the number of updates
    made before this one and ``lr`` the rate for it.

        mu <- b1 * mu + (1 - b1) * g          nu <- b2 * nu + (1 - b2) * g^2
        p  <- p - lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    with t = count + 1.  A first moment stored below f32 follows optax: the
    product ``b1 * mu`` is rounded in the storage dtype, the sum and the
    bias-corrected update are f32, and the new moment is rounded on store.
    """
    # the bias corrections in f32 arithmetic, as optax takes them
    t = np.float32(count + 1)
    correction1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** t)
    correction2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** t)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
    torch._foreach_mul_(mu, ADAM_B1)
    if mu[0].dtype == torch.float32:
        torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
        mu32 = mu
    else:
        mu32 = [m.float() for m in mu]
        torch._foreach_add_(mu32, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_copy_(mu, mu32)
    denom = torch._foreach_div(nu, correction2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    torch._foreach_addcdiv_(params, mu32, denom, value=-lr / correction1)


@dataclasses.dataclass
class Trainer:
    """Trains the joint det+seg objective on one device."""

    model: SsdSegModel
    anchors: Anchors
    config: TrainConfig
    # encoding standard deviations used by the decoded-box IoU metric; must
    # match the EncodingConfig the targets were encoded with
    standard_deviations: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    # where the steps run: the card unless the caller asks for the CPU
    device: str = "cuda"

    def __post_init__(self):
        cfg = self.config
        if cfg.streaming_metrics not in ("full", "loss_only"):
            raise ValueError(
                "streaming_metrics must be 'full' or 'loss_only', got "
                f"{cfg.streaming_metrics!r}"
            )
        for name in ("compute_dtype", "adam_mu_dtype"):
            if getattr(cfg, name) not in _DTYPES:
                raise ValueError(
                    f"{name} must be 'float32' or 'bfloat16', got {getattr(cfg, name)!r}"
                )
        if cfg.mask_loss == "cross_entropy":
            self._mask_loss = losses_lib.cross_entropy(list(cfg.mask_class_weights))
        elif cfg.mask_loss == "dice":
            self._mask_loss = losses_lib.dice(list(cfg.mask_class_weights))
        elif cfg.mask_loss == "dice_square":
            self._mask_loss = losses_lib.dice_square(list(cfg.mask_class_weights))
        else:
            raise ValueError(f"unknown mask loss {cfg.mask_loss!r}")

        n_classes = self.model.cfg.number_of_classes
        det_weights = [0.0] + [1.0 / (n_classes - 1)] * (n_classes - 1)
        self._mask_iou = metrics_lib.jaccard_iou_segmentation_masks(
            list(cfg.mask_class_weights)
        )
        self._box_iou = metrics_lib.jaccard_iou_bounding_boxes(
            self.anchors, tuple(self.standard_deviations)
        )
        self._cat_acc = metrics_lib.categorical_accuracy(det_weights)
        self._lr = lr_schedule_fn(cfg)
        self._compute_dtype = _DTYPES[cfg.compute_dtype]
        self.device = torch.device(self.device)
        # the network's structure on the device; every step supplies the
        # parameters and statistics it runs with
        self._net = copy.deepcopy(self.model).to(
            device=self.device, memory_format=torch.channels_last
        )
        self._param_names = [name for name, _ in self._net.named_parameters()]
        self._stat_names = [
            name for name, _ in self._net.named_buffers() if name.endswith(_STATS)
        ]

    # -- state ------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   variables: Optional[Mapping[str, torch.Tensor]] = None) -> TrainState:
        """A fresh state on the trainer's device: weights drawn from
        ``generator`` (seeded with ``config.seed`` when None), or the
        ``state_dict``-shaped ``variables`` when given."""
        if variables is None:
            if generator is None:
                generator = torch.Generator().manual_seed(self.config.seed)
            variables = SsdSegModel(self.model.cfg, generator).state_dict()

        def own(name: str) -> torch.Tensor:
            t = variables[name].detach().to(self.device, torch.float32, copy=True)
            return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t

        params = {name: own(name) for name in self._param_names}
        mu_dtype = _DTYPES[self.config.adam_mu_dtype]
        return TrainState(
            step=0,
            params=params,
            batch_stats={name: own(name) for name in self._stat_names},
            opt_state=AdamState(
                mu={k: torch.zeros_like(v, dtype=mu_dtype) for k, v in params.items()},
                nu={k: torch.zeros_like(v) for k, v in params.items()},
            ),
        )

    def _to_device(self, images, targets):
        def put(a):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return a.to(self.device, non_blocking=True)

        images = put(images)
        if images.dtype != torch.float32:
            images = images.float()
        return images, {k: put(v) for k, v in targets.items()}

    # -- loss -------------------------------------------------------------
    def _losses_and_metrics(
        self, outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.config
        l_mask = self._mask_loss(targets["output-mask"], outputs["output-mask"]).mean()
        l_conf = losses_lib.confidence_loss(
            targets["output-labels"], outputs["output-labels"],
            negatives_ratio=cfg.hnm_negatives_ratio,
        ).mean()
        l_loc = losses_lib.localization_loss(
            targets["output-boxes"], outputs["output-boxes"]
        ).mean()
        total = (
            cfg.loss_weight_mask * l_mask
            + cfg.loss_weight_labels * l_conf
            + cfg.loss_weight_boxes * l_loc
        )
        metrics = {
            "loss": total,
            "loss/mask": l_mask,
            "loss/labels": l_conf,
            "loss/boxes": l_loc,
        }
        if cfg.streaming_metrics == "full":
            with torch.no_grad():
                metrics.update({
                    "iou/mask": self._mask_iou(
                        targets["output-mask"], outputs["output-mask"]
                    ).mean(),
                    "iou/boxes": self._box_iou(
                        targets["output-boxes"], outputs["output-boxes"]
                    ).mean(),
                    "accuracy/labels": self._cat_acc(
                        targets["output-labels"], outputs["output-labels"]
                    ).mean(),
                })
        return total, {k: v.detach() for k, v in metrics.items()}

    # -- steps ------------------------------------------------------------
    @torch.no_grad()
    def _compute_variables(self, params: Dict[str, torch.Tensor],
                           batch_stats: Dict[str, torch.Tensor]):
        """What the network runs with in one step: (leaves, statistics).  The
        leaves are the parameters in the compute dtype, detached copies that
        require a gradient (`loss_and_grads` casts their gradients back to
        f32, which is what differentiating through the cast would give);
        the statistics are working copies that the forward updates.  Every
        cast is one multi-tensor call, not one launch per tensor.

        In mixed precision every value passes through the compute dtype, as
        in the JAX package.  Conv weights stay in it.  BatchNorm scale, bias
        and statistics come back to f32 after the rounding: the library's
        BatchNorm takes a low-precision input with f32 parameters, does its
        arithmetic in f32 as Flax does, and updates the statistics in f32.
        Flax's update there is ``round(round(momentum) * round(old)) + (1 -
        momentum) * batch`` with all three roundings in the compute dtype
        (in bf16 the momentum 0.99 itself becomes 0.98828125, so the kept
        share and the new share no longer sum to 1: a property of the JAX
        package's mixed-precision step that is reproduced here, not
        repaired).  The working copy handed to the library's ``(1 - m) *
        running + m * batch`` is that rounded product divided by ``(1 - m)``.
        """
        dtype = self._compute_dtype
        masters = [params[k] for k in self._param_names]
        old = [batch_stats[k] for k in self._stat_names]
        stats = [torch.empty_like(v) for v in old]
        if dtype == torch.float32:
            leaves = [p.detach() for p in masters]
            torch._foreach_copy_(stats, old)
        else:
            leaves = [torch.empty_like(p, dtype=dtype) for p in masters]
            torch._foreach_copy_(leaves, masters)
            vectors = [i for i, p in enumerate(masters) if p.dim() == 1]
            rounded = [torch.empty_like(masters[i]) for i in vectors]
            torch._foreach_copy_(rounded, [leaves[i] for i in vectors])
            for i, t in zip(vectors, rounded):
                leaves[i] = t
            low = [torch.empty_like(v, dtype=dtype) for v in old]
            torch._foreach_copy_(low, old)
            keep = 1.0 - BN_MOMENTUM
            torch._foreach_mul_(low, float(torch.tensor(keep, dtype=dtype)))
            torch._foreach_copy_(stats, low)
            torch._foreach_div_(stats, keep)
        for t in leaves:
            t.requires_grad_()
        return dict(zip(self._param_names, leaves)), dict(zip(self._stat_names, stats))

    def loss_and_grads(self, state: TrainState, images, targets):
        """Train-mode forward and backward on one batch, without an update.

        Returns (metrics, grads, new_batch_stats): 0-d device tensors, f32
        gradients keyed like ``state.params`` and laid out like them, and
        the running statistics after this forward (``state`` itself is left
        as it was).
        """
        images, targets = self._to_device(images, targets)
        leaves, stats = self._compute_variables(state.params, state.batch_stats)
        images = images.to(self._compute_dtype)
        self._net.train()

        def forward(x):
            return functional_call(self._net, {**leaves, **stats}, (x,))

        if self.config.remat:
            # rematerialize the forward in the backward pass instead of
            # storing the activations
            outputs = checkpoint(forward, images, use_reentrant=False)
        else:
            outputs = forward(images)
        new_stats = stats
        if self.config.remat:
            # the statistics of THIS forward: the rematerialized second
            # forward updates the working copies once more
            new_stats = {k: torch.empty_like(v) for k, v in stats.items()}
            with torch.no_grad():
                torch._foreach_copy_(list(new_stats.values()), list(stats.values()))
        outputs = {k: v.float() for k, v in outputs.items()}
        total, metrics = self._losses_and_metrics(outputs, targets)
        names = self._param_names
        grads = torch.autograd.grad(total, [leaves[k] for k in names])
        # f32, in the masters' memory layout: one multi-tensor copy
        masters = [state.params[k] for k in names]
        if any(g.dtype != p.dtype or g.stride() != p.stride() for g, p in zip(grads, masters)):
            laid_out = [torch.empty_like(p) for p in masters]
            with torch.no_grad():
                torch._foreach_copy_(laid_out, list(grads))
            grads = laid_out
        return metrics, dict(zip(names, grads)), new_stats

    def train_step(self, state: TrainState, images, targets):
        """One optimisation step on a batch, updating ``state`` in place.

        Args:
            images: (B, H, W, 3) in [0, 255], NumPy or tensor.
            targets: {'output-mask' (B, H, W, C) one-hot, 'output-labels'
                (B, N, C) one-hot, 'output-boxes' (B, N, 4) offsets}.
        Returns:
            (state, metrics); the metrics are 0-d tensors on the device.
        """
        metrics, grads, new_stats = self.loss_and_grads(state, images, targets)
        names = self._param_names
        with torch.no_grad():
            adam_update(
                [state.params[k] for k in names], [grads[k] for k in names],
                [state.opt_state.mu[k] for k in names],
                [state.opt_state.nu[k] for k in names],
                count=state.step, lr=self._lr(state.step),
            )
            torch._foreach_copy_([state.batch_stats[k] for k in self._stat_names],
                                 [new_stats[k] for k in self._stat_names])
        state.step += 1
        return state, metrics

    def train_step_fn(self) -> Callable:
        return self.train_step

    @torch.no_grad()
    def eval_step(self, state: TrainState, images, targets) -> Dict[str, torch.Tensor]:
        """Eval-mode forward in f32 with the running statistics: metrics."""
        images, targets = self._to_device(images, targets)
        self._net.eval()
        outputs = functional_call(self._net, state.variables(), (images,))
        _, metrics = self._losses_and_metrics(outputs, targets)
        return metrics

    def eval_step_fn(self) -> Callable:
        return self.eval_step

    @torch.no_grad()
    def recalibrate_batch_stats(self, state: TrainState, batches,
                                max_batches: int = 64) -> TrainState:
        """PreciseBN: replace the EMA BatchNorm statistics with the population
        statistics estimated over training batches, in place.

        Each batch runs a train-mode f32 forward with the momentum set to 1,
        so the working statistics ARE the batch's own (biased variance); the
        population variance is E[var_b + mean_b^2] - E[mean_b]^2.

        Args:
            batches: iterable of (images, targets) training batches (targets
                unused); only the first `max_batches` are read.
        """
        norms = [m for m in self._net.modules()
                 if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
        momenta = [m.momentum for m in norms]
        acc: Dict[str, torch.Tensor] = {}
        n = 0
        self._net.train()
        try:
            for m in norms:
                m.momentum = 1.0
            for item in batches:
                if n >= max_batches:
                    break
                images, _ = self._to_device(item[0], {})
                stats = {k: v.clone() for k, v in state.batch_stats.items()}
                functional_call(self._net, {**state.params, **stats}, (images,))
                for name in self._stat_names:
                    if not name.endswith("running_mean"):
                        continue
                    mean = stats[name]
                    var = stats[name[:-len("mean")] + "var"]
                    slot = acc.setdefault(
                        name, [torch.zeros_like(mean), torch.zeros_like(mean)])
                    slot[0] += mean
                    slot[1] += var + mean * mean
                n += 1
        finally:
            for m, momentum in zip(norms, momenta):
                m.momentum = momentum
        for name, (mean_sum, m2_sum) in acc.items():
            e_mean = mean_sum / n
            state.batch_stats[name].copy_(e_mean)
            state.batch_stats[name[:-len("mean")] + "var"].copy_(
                (m2_sum / n - e_mean * e_mean).clamp_min(0.0))
        return state

    # -- loop -------------------------------------------------------------
    def fit(
        self,
        state: TrainState,
        train_data: Iterable,
        epochs: Optional[int] = None,
        validation_data: Optional[Iterable] = None,
        mesh=None,
        checkpointer=None,
        log_fn: Callable[[str], None] = print,
        steps_per_epoch: Optional[int] = None,
        metrics_logger=None,
        resume: bool = False,
    ) -> Tuple[TrainState, Dict[str, list]]:
        """Epoch loop over (images, targets) batches.

        `train_data` / `validation_data` are callables returning a fresh
        iterator per epoch, or re-iterable objects.  Metrics accumulate on
        the device; the host reads them once per epoch.
        """
        for name, value in (("mesh", mesh), ("checkpointer", checkpointer)):
            if value is not None:
                raise NotImplementedError(f"fit({name}=...) is not ported yet")
        if resume:
            raise NotImplementedError("fit(resume=True) needs a checkpointer")
        for data in (train_data, validation_data):
            if hasattr(data, "iter_raw") and hasattr(data, "transform"):
                raise NotImplementedError(
                    "loaders with a device-side transform (transform-fused "
                    "steps) are not ported yet; pass (images, targets) batches"
                )
        epochs = epochs or self.config.epochs
        history: Dict[str, list] = {}

        def _epoch_iter(data):
            return data() if callable(data) else data

        def _run(step, data, limit):
            agg: Dict[str, torch.Tensor] = {}
            n = 0
            for images, targets in _epoch_iter(data):
                metrics = step(images, targets)
                n += 1
                for k, v in metrics.items():
                    agg[k] = v if k not in agg else agg[k] + v
                if limit and n >= limit:
                    break
            return agg, n

        for epoch in range(epochs):
            t0 = time.perf_counter()
            agg, n = _run(lambda i, t: self.train_step(state, i, t)[1], train_data,
                          steps_per_epoch)
            for k in agg:
                history.setdefault(k, []).append(float(agg[k]) / max(n, 1))
            if validation_data is not None:
                vagg, vn = _run(lambda i, t: self.eval_step(state, i, t),
                                validation_data, None)
                for k in vagg:
                    history.setdefault(f"val_{k}", []).append(float(vagg[k]) / max(vn, 1))

            dt = time.perf_counter() - t0
            msg = f"epoch {epoch + 1}/{epochs} [{dt:.1f}s, {n} steps]"
            for k in ("loss", "iou/mask", "iou/boxes"):
                if k in history:
                    msg += f" {k}={history[k][-1]:.4f}"
                if f"val_{k}" in history:
                    msg += f" val_{k}={history[f'val_{k}'][-1]:.4f}"
            log_fn(msg)
            if metrics_logger is not None:
                metrics_logger.log({k: v[-1] for k, v in history.items()}, step=state.step)
        return state, history
