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

`fit` takes plain (images, targets) batches or a loader that exposes its raw
host batches and its device-side transform (``data/pipeline.TrainDataLoader``):
then the transform runs inside the step, on raw batches uploaded in chunks
through pinned memory, and the host never waits for the device inside an
epoch.  With a ``checkpointer`` the state is saved after every epoch and
``resume=True`` restarts from the latest step.

Data parallelism (``mesh=``, a `parallel.make_mesh` mesh): `init_state`
replicates rank 0's state and the state keeps its mesh; every step then runs
this rank's slice of the global batch inside `parallel.mesh.data_parallel`
(global-batch BatchNorm and hard-negative mining), averages the gradients
over the ranks in ONE all_reduce of one flat f32 buffer, and averages the
metrics in one more, all on the device.  Every rank applies the same
all-reduced values, so the replicas stay bitwise equal.  `fit` hands each
rank its slice: of each plain global batch through `shard_batch`, or from a
`TrainDataLoader` built with the same mesh.

On a ``("data", "spatial")`` mesh (`parallel.make_hybrid_mesh`) each rank
also holds only its rows of the images and of the mask target (taken by the
step from a batch slice that comes with every row, `shard_images`); the
model's forward exchanges and reduces rows (`parallel.spatial`), and the
gradient and metric means run over every rank of the mesh.
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
from ssdseglib_torch.parallel import mesh as mesh_lib
from ssdseglib_torch.parallel import spatial
from ssdseglib_torch.utils.profiling import span

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
    optimizer state, keyed by the model's ``state_dict`` names; ``mesh`` is
    the data-parallel mesh the state is replicated over (None: one
    process)."""

    step: int
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: AdamState
    mesh: Optional[object] = None

    @classmethod
    def create(cls, variables: Mapping[str, torch.Tensor],
               adam_mu_dtype: str = "float32") -> "TrainState":
        """Step 0 with zero Adam moments (``optax.adam(...).init``) for a
        ``state_dict``-shaped mapping, whose tensors are taken as they are:
        the running statistics become ``batch_stats``, every other entry but
        BatchNorm's ``num_batches_tracked`` a parameter."""
        batch_stats = {k: v for k, v in variables.items() if k.endswith(_STATS)}
        params = {k: v for k, v in variables.items()
                  if k not in batch_stats and not k.endswith("num_batches_tracked")}
        mu_dtype = _DTYPES[adam_mu_dtype]
        return cls(step=0, params=params, batch_stats=batch_stats, opt_state=AdamState(
            mu={k: torch.zeros_like(v, dtype=mu_dtype) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()}))

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
    # the decoded-box IoU metric's anchors; None only with
    # ``streaming_metrics='loss_only'``, which does not compute it
    anchors: Optional[Anchors]
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
        if self.anchors is None and cfg.streaming_metrics == "full":
            raise ValueError("streaming_metrics='full' needs the anchors of the box IoU metric")
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
        self._box_iou = None if self.anchors is None else (
            metrics_lib.jaccard_iou_bounding_boxes(self.anchors, tuple(self.standard_deviations)))
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
        # BatchNorm's scale and bias: the library's BatchNorm takes them in
        # f32 (see `_compute_variables`); every other parameter, conv biases
        # included, runs in the compute dtype
        norms = [f"{prefix}.{name}" for prefix, m in self._net.named_modules()
                 if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                 for name, _ in m.named_parameters(recurse=False)]
        self._norm_params = [i for i, name in enumerate(self._param_names) if name in norms]
        self._stat_names = [
            name for name, _ in self._net.named_buffers() if name.endswith(_STATS)
        ]
        self._fused_steps: Dict[Tuple[str, int], Tuple[Callable, Callable]] = {}

    # -- state ------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   variables: Optional[Mapping[str, torch.Tensor]] = None,
                   mesh=None) -> TrainState:
        """A fresh state on the trainer's device: weights drawn from
        ``generator`` (seeded with ``config.seed`` when None), or the
        ``state_dict``-shaped ``variables`` when given.  With a ``mesh``,
        rank 0's state, replicated on every rank."""
        if variables is None:
            if generator is None:
                generator = torch.Generator().manual_seed(self.config.seed)
            variables = SsdSegModel(self.model.cfg, generator).state_dict()

        def own(name: str) -> torch.Tensor:
            t = variables[name].detach().to(self.device, torch.float32, copy=True)
            return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t

        state = TrainState.create({name: own(name)
                                   for name in self._param_names + self._stat_names},
                                  self.config.adam_mu_dtype)
        return state if mesh is None else self._replicate_state(state, mesh)

    def _replicate_state(self, state: TrainState, mesh) -> TrainState:
        """A new state holding rank 0's values of ``state`` on every rank of
        ``mesh`` (one broadcast per dtype), with the mesh recorded."""
        tensors = mesh_lib.replicate(mesh, {
            "params": state.params, "batch_stats": state.batch_stats,
            "mu": state.opt_state.mu, "nu": state.opt_state.nu,
            "step": torch.tensor([state.step], dtype=torch.int64)})
        return TrainState(
            step=int(tensors["step"][0]), params=tensors["params"],
            batch_stats=tensors["batch_stats"],
            opt_state=AdamState(mu=tensors["mu"], nu=tensors["nu"]), mesh=mesh)

    @staticmethod
    def _mean_over_ranks(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
        """The ranks' mean of 0-d metrics: one all_reduce, on the device.
        Exact for the batch means of per-sample values over equal shards
        (the spatial ranks of one batch slice hold the same values)."""
        values = torch.stack(list(metrics.values()))
        mesh_lib.all_reduce_(values, group).div_(torch.distributed.get_world_size(group))
        return dict(zip(metrics, values.unbind()))

    def _to_device(self, images, targets):
        def put(a):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return a.to(self.device, non_blocking=True)

        images = put(images)
        if images.dtype != torch.float32:
            images = images.float()
        return images, {k: put(v) for k, v in targets.items()}

    def _own_rows(self, mesh, images: torch.Tensor, targets: Dict[str, torch.Tensor]):
        """On a mesh that splits the rows, this rank's rows of the images and
        of the mask target where they come with every row (a batch slice from
        `parallel.shard_batch` or from a loader built with the mesh): the
        images through `parallel.shard_images`."""
        if mesh is None or mesh_lib.spatial_size(mesh) == 1:
            return images, targets
        height = self.model.cfg.input_image_shape[0]
        if images.shape[1] == height:
            images = mesh_lib.shard_images(mesh, images, batch_is_local=True)
        mask = targets.get("output-mask")
        if mask is not None and mask.shape[1] == height:
            targets = {**targets, "output-mask": spatial.shard_rows(mesh, mask)}
        return images, targets

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
        in the JAX package.  Conv weights and biases stay in it.  BatchNorm scale, bias
        and statistics come back to f32 after the rounding: the library's
        BatchNorm takes a low-precision input with f32 parameters, does its
        arithmetic in f32 as Flax does, and updates the statistics in f32.
        The JAX package's compiled step updates them as ``round(momentum) *
        round(old) + (1 - momentum) * batch``: the old statistic and the
        momentum are rounded to the compute dtype, and the product is not (XLA
        keeps it in f32, where Flax run op by op would round it too).  In bf16
        the momentum 0.99 becomes 0.98828125, so the kept share and the new
        share no longer sum to 1: a property of the JAX package's
        mixed-precision step that is reproduced here, not repaired.  The
        working copy handed to the library's ``(1 - m) * running + m *
        batch`` is that product divided by ``(1 - m)``.
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
            vectors = self._norm_params
            rounded = [torch.empty_like(masters[i]) for i in vectors]
            torch._foreach_copy_(rounded, [leaves[i] for i in vectors])
            for i, t in zip(vectors, rounded):
                leaves[i] = t
            low = [torch.empty_like(v, dtype=dtype) for v in old]
            torch._foreach_copy_(low, old)
            torch._foreach_copy_(stats, low)
            keep = 1.0 - BN_MOMENTUM
            torch._foreach_mul_(stats, float(torch.tensor(keep, dtype=dtype)) / keep)
        for t in leaves:
            t.requires_grad_()
        return dict(zip(self._param_names, leaves)), dict(zip(self._stat_names, stats))

    def loss_and_grads(self, state: TrainState, images, targets):
        """Train-mode forward and backward on one batch, without an update.

        Returns (metrics, grads, new_batch_stats): 0-d device tensors, f32
        gradients keyed like ``state.params`` and laid out like them, and
        the running statistics after this forward (``state`` itself is left
        as it was).  On a mesh (``state.mesh``) the batch is this rank's
        slice, and metrics and gradients are the global batch's: their means
        over the ranks.
        """
        mesh = state.mesh
        images, targets = self._own_rows(mesh, *self._to_device(images, targets))
        leaves, stats = self._compute_variables(state.params, state.batch_stats)
        images = images.to(self._compute_dtype)
        self._net.train()

        def forward(x):
            # the scope is entered here so that a rematerialized forward,
            # which runs inside the backward, reduces over the group too
            with mesh_lib.data_parallel(mesh):
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
        with mesh_lib.data_parallel(mesh):
            total, metrics = self._losses_and_metrics(outputs, targets)
        names = self._param_names
        grads = torch.autograd.grad(total, [leaves[k] for k in names])
        masters = [state.params[k] for k in names]
        if mesh is not None:
            group = mesh_lib.mesh_group(mesh)
            grads = self._mean_gradients(masters, grads, group)
            metrics = self._mean_over_ranks(metrics, group)
        elif any(g.dtype != p.dtype or g.stride() != p.stride()
                 for g, p in zip(grads, masters)):
            # f32, in the masters' memory layout: one multi-tensor copy
            laid_out = [torch.empty_like(p) for p in masters]
            with torch.no_grad():
                torch._foreach_copy_(laid_out, list(grads))
            grads = laid_out
        return metrics, dict(zip(names, grads)), new_stats

    @staticmethod
    @torch.no_grad()
    def _mean_gradients(masters: List[torch.Tensor], grads, group) -> List[torch.Tensor]:
        """The ranks' mean of ``grads``: one multi-tensor copy into one flat
        buffer of the masters' dtype (f32), ONE all_reduce of it, one division.  Returns views of the
        buffer laid out like ``masters``.  Over every rank of a 2-D mesh: the
        spatial ranks' partial gradients are summed and the data ranks'
        averaged (`parallel.spatial`, Gradients)."""
        flat = torch.empty(sum(p.numel() for p in masters), dtype=masters[0].dtype,
                           device=masters[0].device)
        views, offset = [], 0
        for p in masters:
            views.append(flat.as_strided(p.shape, p.stride(), offset))
            offset += p.numel()
        torch._foreach_copy_(views, list(grads))
        mesh_lib.all_reduce_(flat, group).div_(torch.distributed.get_world_size(group))
        return views

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
        """Eval-mode forward in f32 with the running statistics: metrics (on
        a mesh, this rank's slice in, the global batch's metrics out)."""
        images, targets = self._own_rows(state.mesh, *self._to_device(images, targets))
        self._net.eval()
        with mesh_lib.data_parallel(state.mesh):
            outputs = functional_call(self._net, state.variables(), (images,))
            _, metrics = self._losses_and_metrics(outputs, targets)
        if state.mesh is not None:
            metrics = self._mean_over_ranks(metrics, mesh_lib.mesh_group(state.mesh))
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
                unused; on a mesh, this rank's slices, whose statistics are
                then the global batch's); only the first `max_batches` are
                read.
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
                images, _ = self._own_rows(state.mesh, *self._to_device(item[0], {}))
                stats = {k: v.clone() for k, v in state.batch_stats.items()}
                with mesh_lib.data_parallel(state.mesh):
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

    # -- transform-fused steps ---------------------------------------------
    # A loader's device-side transform (flip / color / one-hot / anchor
    # matching) and the step as one call on a raw uploaded batch.  PyTorch
    # runs eagerly, so nothing is compiled together: what the fusion buys
    # here is that the loader hands over raw uint8 batches (a quarter of the
    # bytes of f32 images, no targets) and the caller decides when they are
    # uploaded.

    def _fused_step_fn(self, kind: str, transform: Callable, inner: Callable) -> Callable:
        # the cache holds a strong reference to the transform so its id()
        # stays valid for the lifetime of the cached entry (a freed id can
        # be reused by CPython and would alias a different transform)
        key = (kind, id(transform))
        if key not in self._fused_steps:
            def fused(state: TrainState, rng, *raw_batch):
                images, targets = transform(rng, *raw_batch)
                return inner(state, images, targets)

            self._fused_steps[key] = (transform, fused)
        return self._fused_steps[key][1]

    def fused_train_step_fn(self, transform: Callable) -> Callable:
        """``fused(state, generator, *raw_batch) -> (state, metrics)``."""
        return self._fused_step_fn("train", transform, self.train_step)

    def fused_eval_step_fn(self, transform: Callable) -> Callable:
        """``fused(state, generator, *raw_batch) -> metrics``."""
        return self._fused_step_fn("eval", transform, self.eval_step)

    def _staged(self, raw_iter, chunk_size: int = 8, first_step: int = 0):
        """Chunked host -> device staging for fused steps: ``chunk_size`` raw
        host batches are buffered, then uploaded together (pinned staging,
        non-blocking copies) and their steps dispatched back to back.  The
        copies are queued on the current stream, behind the steps of the
        chunk before: the stream's order is the fence on the last metric
        that the JAX package has to ask for, and the host waits for
        nothing.  Each chunk's upload is the span ``train.stage``, indexed
        by the step of its first batch (``first_step`` for the first)."""
        from ssdseglib_torch.data.pipeline import upload_batch

        def upload(buf, step):
            with span("train.stage", step):
                return [(rng, upload_batch(b, self.device)) for rng, b in buf]

        buf, step = [], first_step
        for item in raw_iter:
            buf.append(item)
            if len(buf) >= chunk_size:
                yield from upload(buf, step)
                step += len(buf)
                buf = []
        if buf:
            yield from upload(buf, step)

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
        iterator per epoch, or re-iterable objects; loaders exposing
        ``iter_raw`` and ``transform`` (`TrainDataLoader`) run through the
        transform-fused steps.  Metrics accumulate on the device; the host
        reads them once per epoch.  With a ``checkpointer`` the state is
        saved after every epoch; with ``resume=True`` and a checkpointer
        holding a prior step, training restarts from the latest checkpoint.

        With a ``mesh`` (`parallel.make_mesh` or `parallel.make_hybrid_mesh`;
        every rank calls `fit` alike) the state is replicated on it, each
        plain global batch is sharded (`parallel.shard_batch`, and the step
        takes the rows), a loader must have been built with the same mesh,
        and the history holds the global batch's metrics.  Anything that is
        no DeviceMesh raises TypeError.

        While a profiler records, each epoch is the span ``train.epoch``,
        each step ``train.step`` (``train.eval_step`` in validation) and each
        chunk's upload ``train.stage`` (`utils.profiling.span`).
        """
        if mesh is not None:
            mesh_lib.check_mesh(mesh)
        epochs = epochs or self.config.epochs
        restored = False
        if resume and checkpointer is not None:
            latest = checkpointer.latest_step()
            if latest is not None:
                state, restored = checkpointer.restore(state), True
                log_fn(f"resumed from checkpoint step {latest}")
        if mesh is not None and (restored or state.mesh is not mesh):
            state = self._replicate_state(state, mesh)

        def _epoch(data, step: Callable, fused_step_fn: Callable, name: str) -> Callable:
            """A generator function over what ``step`` returns for each batch
            of one epoch of ``data``, each step the span ``name`` indexed by
            the global step."""
            if hasattr(data, "iter_raw") and hasattr(data, "transform"):
                if getattr(data, "mesh", None) is not mesh:
                    raise ValueError(
                        "fit(mesh=...) takes a loader built with the same mesh "
                        "(TrainDataLoader(..., mesh=mesh)), and fit without a mesh one "
                        "built without"
                    )
                fused = fused_step_fn(data.transform)

                def run():
                    for rng, batch in self._staged(data.iter_raw(), first_step=state.step):
                        with span(name, state.step):
                            out = fused(state, rng, *batch)
                        yield out
            else:
                def run():
                    for images, targets in (data() if callable(data) else data):
                        with span(name, state.step):
                            if mesh is not None:
                                images, targets = mesh_lib.shard_batch(mesh, (images, targets))
                            out = step(state, images, targets)
                        yield out
            return run

        def _run(metrics_of_steps, limit: Optional[int]):
            # accumulate metrics ON DEVICE: a float() per step would force a
            # device sync that serializes host decode / transfer / compute
            agg: Dict[str, torch.Tensor] = {}
            n = 0
            for metrics in metrics_of_steps:
                n += 1
                for k, v in metrics.items():
                    agg[k] = v if k not in agg else agg[k] + v
                if limit and n >= limit:
                    break
            return agg, n

        train_epoch = _epoch(train_data, self.train_step, self.fused_train_step_fn, "train.step")
        if validation_data is not None:
            eval_epoch = _epoch(validation_data, self.eval_step, self.fused_eval_step_fn,
                                "train.eval_step")
        history: Dict[str, list] = {}
        for epoch in range(epochs):
            with span("train.epoch", epoch):
                t0 = time.perf_counter()
                agg, n = _run((metrics for _, metrics in train_epoch()), steps_per_epoch)
                for k in agg:
                    history.setdefault(k, []).append(float(agg[k]) / max(n, 1))
                if validation_data is not None:
                    vagg, vn = _run(eval_epoch(), None)
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
                if checkpointer is not None:
                    checkpointer.save(state.step, state)

        if checkpointer is not None and hasattr(checkpointer, "wait_until_finished"):
            # a checkpointer may write in the background: fence before
            # returning so a process that exits right after fit() cannot lose
            # the final epoch's checkpoint
            checkpointer.wait_until_finished()
        return state, history
