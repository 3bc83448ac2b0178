"""Training driver: ``Trainer.fit`` over a ``TrainDataLoader`` of seeded
in-memory scenes, one epoch a call, as a user runs it (the configuration's
``train`` recipe; no checkpointer, no validation).

Set-up: the scenes, the seeded raw weights, the trainer, the loader and its
state; then ``warmup_epochs`` epochs through the window's own call and
feed, whose first ``followed_steps`` steps the reference follows from the
seeded weights.  Window: ``fit`` epoch after epoch until the window's time
has passed; every step of every finished epoch counts, loader, staging,
transform and the epoch-end read of the metrics included.  In each window
epoch ``followed_steps`` steps from an offset drawn from the seed are
recorded, and the reference follows the last epoch's from the program's
state before them.  A followed run records the state before its first step
(step count, parameters, Adam's moments), each step's loss, Adam's first
moment after the first step and the parameters after the last.  With a
trace, ``trace_epochs`` more epochs run under the profiler.  The harness's
loader wrapper times each ``next()`` that ``fit`` waits on.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import program, scenes
from benchmark.harness.trace import Spans, profiled
from benchmark.harness.weights import draw
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.work import flops

FAULTS = ("half_batch", "altered")
ADAM_B1 = 0.9


class _TimedLoader:
    """The program's loader as ``fit`` sees it, with each ``next()`` on its
    raw batches timed; ``half_batch`` (tests and calibration only) hands the
    step the first half of every batch."""

    def __init__(self, loader, spans_of, fault: Optional[str]) -> None:
        self.loader, self.spans_of, self.mesh = loader, spans_of, None
        self.transform = loader.transform
        if fault == "half_batch":
            def transform(rng, *raw):
                images, targets = loader.transform(rng, *raw)
                half = len(images) // 2
                return images[:half], {k: v[:half] for k, v in targets.items()}
            self.transform = transform

    def __len__(self) -> int:
        return len(self.loader)

    def iter_raw(self):
        it = iter(self.loader.iter_raw())
        while True:
            with self.spans_of().span("train.loader_wait"):
                item = next(it, None)
            if item is None:
                return
            yield item


def _copy(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of a dict of tensors in a few multi-tensor launches."""
    return dict(zip(tensors, torch._foreach_mul(list(tensors.values()), 1.0)))


class _Followed:
    """The record of one followed run, from global step ``first`` on."""

    def __init__(self, state, first: int) -> None:
        self.first = first
        self.p0, self.mu0 = _copy(state.params), _copy(state.opt_state.mu)
        self.nu0 = _copy(state.opt_state.nu)
        self.losses: List[torch.Tensor] = []
        self.mu1 = self.p_end = None


class Session:
    def __init__(self, cell, seed: int, device, log, fault: Optional[str] = None) -> None:
        self.cell, self.seed, self.device, self.log, self.fault = cell, seed, device, log, fault
        self.mix, self.config = cell.mix, cell.config
        self.split: Dict[str, float] = {}
        self.spans = Spans()

    def setup(self) -> None:
        from ssdseglib_torch.config import TrainConfig
        from ssdseglib_torch.data.pipeline import TrainDataLoader
        from ssdseglib_torch.data.synthetic import SyntheticSample
        from ssdseglib_torch.train import Trainer

        mix, config, tcfg = self.mix, self.config, self.config["train"]
        t = time.perf_counter()
        hw = tuple(config["encoding"]["image_shape"])
        self.scenes = scenes.scenes(mix["scenes"], self.seed, hw)
        samples = [SyntheticSample(image=i, mask=m, labels=l, boxes=b) for i, m, l, b in self.scenes]
        self.split["data generation"] = time.perf_counter() - t

        t = time.perf_counter()
        self.weights = draw(config["model"], self.seed, self.device)
        anchor_set = program.anchors(config)
        build = program.builder(config, anchor_set)
        net = program.network(config, build, self.weights, self.device)
        recipe = {k: v for k, v in tcfg.items()
                  if k not in ("augmentation_horizontal_flip", "augmentation_rgb")}
        recipe["mask_class_weights"] = tuple(recipe["mask_class_weights"])
        self.trainer = Trainer(net, anchor_set, TrainConfig(batch_size=mix["batch"], **recipe),
                               standard_deviations=tuple(config["encoding"]["standard_deviations"]),
                               device=str(self.device))
        del net
        self.loader_seed = self.seed
        loader = TrainDataLoader(samples, anchor_set, program.encoding(config), mix["batch"],
                                 augmentation_horizontal_flip=tcfg["augmentation_horizontal_flip"],
                                 augmentation_rgb=tcfg["augmentation_rgb"], seed=self.loader_seed,
                                 device=self.device)
        self.loader = _TimedLoader(loader, lambda: self.spans, self.fault if self.fault == "half_batch" else None)
        self.steps_per_epoch = len(loader)
        self.state = self.trainer.init_state(variables=self.weights)
        self.split["model build"] = time.perf_counter() - t

        t = time.perf_counter()
        self._follow()
        for _ in range(mix["warmup_epochs"]):
            self.trainer.fit(self.state, self.loader, epochs=1, log_fn=_quiet)
        self.split["warm-up"] = time.perf_counter() - t

    def _follow(self) -> None:
        """Wrap the step so that it records the followed runs: one starts at
        each global step in ``self.starts`` (its value names the run; a
        later run of the same name replaces the earlier); the first is the
        set-up's."""
        step, followed = self.trainer.train_step, self.mix["followed_steps"]
        self.count, self.starts, self.followed = 0, {0: "setup"}, {}
        current: List[Optional[_Followed]] = [None]

        def recorded(st, images, targets):
            i = self.count
            self.count += 1
            if i in self.starts:
                current[0] = self.followed[self.starts[i]] = _Followed(st, i)
            f = current[0]
            before = None
            if i == 0 and self.fault == "altered":
                before = {k: v.clone() for k, v in st.params.items()}
            st, metrics = step(st, images, targets)
            if before is not None:
                # the first update of the first leaf, applied twice
                k = next(iter(before))
                st.params[k].add_(st.params[k] - before[k])
            if f is not None:
                f.losses.append(metrics["loss"].detach().clone())
                if i == f.first:
                    f.mu1 = _copy(st.opt_state.mu)
                if i == f.first + followed - 1:
                    f.p_end = _copy(st.params)
                    current[0] = None
            return st, metrics

        # fit's transform-fused step keeps this wrapper; outside the
        # followed runs it only counts the call and passes it through
        self.trainer.train_step = recorded

    def window(self, seconds: float, trace: bool) -> Dict:
        self.spans = Spans()
        steps_per_epoch = self.steps_per_epoch
        offset = self.seed % (steps_per_epoch - self.mix["followed_steps"] + 1)
        t0 = time.perf_counter()
        epochs = 0
        ends = []
        while time.perf_counter() - t0 < seconds:
            self.starts = {self.count + offset: "window"}
            with self.spans.span("train.fit"):
                self.trainer.fit(self.state, self.loader, epochs=1, log_fn=_quiet)
            epochs += 1
            ends.append(time.perf_counter() - t0)
        t_end = time.perf_counter()
        self.starts = {}
        self.log("[train] seconds of each epoch in the window: "
                 f"{[round(b - a, 4) for a, b in zip([0.0] + ends, ends)]}")
        steps = epochs * steps_per_epoch
        rate = steps * self.mix["batch"] / (t_end - t0)
        out = {"attempted": steps, "failed": 0, "images_per_s": rate, "spans": self.spans,
               "metrics": {"train_images_per_s": rate}}
        if trace:
            traced = Spans()
            self.spans = traced
            n = self.mix["trace_epochs"]
            with profiled(traced) as prof:
                for _ in range(n):
                    with traced.span("train.fit"):
                        self.trainer.fit(self.state, self.loader, epochs=1, log_fn=_quiet)
            timeline = prof["timeline"]
            out["trace"] = {"timeline": timeline, "units": n * steps_per_epoch, "spans": traced}
        return out

    def release(self) -> None:
        self.trainer = self.state = self.loader = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _raw_batches(self, first: int):
        """The raw uint8 batches of the followed steps from global step
        ``first`` on, on the device."""
        budget = self.config["encoding"]["max_ground_truth_boxes"]
        epoch, offset = divmod(first, self.steps_per_epoch)
        order = ref_train.epoch_order(len(self.scenes), self.mix["batch"], self.loader_seed, epoch)
        out = []
        for idx in order[offset: offset + self.mix["followed_steps"]]:
            rows = [self.scenes[i] for i in idx]
            gt = [scenes.padded(l, b, budget) for _, _, l, b in rows]
            arrays = (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
                      np.stack([g[0] for g in gt]), np.stack([g[1] for g in gt]),
                      np.stack([g[2] for g in gt]))
            out.append(tuple(torch.from_numpy(a).to(self.device) for a in arrays))
        return out

    def reference_steps(self, run: str = "setup", precision: str = "float32"):
        """The reference's steps of the followed ``run``: (losses, first
        gradients, final parameters).  'setup' starts from the seeded weights
        with Adam's moments at zero; 'window' from the program's state before
        its first step (the reference cannot work out ~100 bf16 steps
        again), with the loader's order and augmentation draws of that step
        worked out from the seed.  ``precision`` 'fp8' is the control,
        'bfloat16' a witness of bf16 rounding (calibration only)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        f = self.followed[run]
        start = self.weights if run == "setup" else f.p0
        moments = None if run == "setup" else (f.mu0, f.nu0)
        net = ref_model.build(self.config["model"], self.weights, self.device)
        corners, _ = _anchors(self.config)
        gen = torch.Generator(device=self.device).manual_seed(self.loader_seed)
        tcfg = self.config["train"]
        flip_on, rgb_on = tcfg["augmentation_horizontal_flip"], tcfg["augmentation_rgb"]
        for _ in range(f.first):  # the draws of every step before
            ref_train.draws(gen, self.mix["batch"], flip_on, rgb_on)
        dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
        with ref_model.precision("fp8" if precision == "fp8" else "float32"):
            result = ref_train.train_steps(
                net, start, self._raw_batches(f.first), gen,
                torch.from_numpy(corners).to(self.device), self.config["encoding"], tcfg,
                flip_on, rgb_on, dtype, moments=moments, count=f.first)
        del net
        return result

    def judge(self, control=False) -> Dict[str, float]:
        """The numbers compared: those of the set-up's followed steps, and
        the same of the window's under ``window_`` names.  ``control``: True
        or 'fp8' puts the reference in fp8 in the program's place,
        'bfloat16' the bf16 witness (calibration only)."""
        numbers: Dict[str, float] = {}
        for run in ("setup", "window"):
            f = self.followed[run]
            ref_losses, ref_grads, ref_params = self.reference_steps(run)
            if control:
                losses, grads, params = self.reference_steps(
                    run, "fp8" if control is True else control)
            else:
                losses = [float(v) for v in f.losses]
                grads = {k: (v.float() - ADAM_B1 * f.mu0[k].float()) / (1.0 - ADAM_B1)
                         for k, v in f.mu1.items()}
                params = f.p_end
            got = compare_steps(losses, grads, params, ref_losses, ref_grads, ref_params, f.p0)
            prefix = "" if run == "setup" else "window_"
            numbers.update({prefix + k: v for k, v in got.items()})
        numbers["window_first_step"] = self.followed["window"].first
        return numbers

    def work(self) -> Dict[str, float]:
        return {"forward_flops_per_image": flops.forward_flops_per_image(self.config["model"]),
                "train_flops_per_image": flops.train_flops_per_image(self.config["model"]),
                "batch": self.mix["batch"]}


@torch.no_grad()
def compare_steps(losses, grads, params, ref_losses, ref_grads, ref_params, p0) -> Dict[str, float]:
    """The followed steps against the reference's:
    - ``loss1_gap`` / ``loss_gap``: |loss - reference| / |reference| of the
      first step / the largest over the followed steps;
    - ``grad_gap`` / ``grad_gap_median``: the first step's gradients, leaf by
      leaf |norm - reference norm| over the larger of that leaf's reference
      norm and the median leaf's: the worst leaf / the median leaf;
    - ``change_gap`` / ``change_gap_median``: the same of each leaf's change
      over the followed steps, over the leaves whose first reference
      gradient is at least a thousandth of the median leaf's (the others move
      under Adam by rounding alone)."""
    def norms(d, keys):
        return torch.stack([d[k].detach().float().norm() for k in keys])

    keys = sorted(ref_grads)
    g_ref, g = norms(ref_grads, keys), norms(grads, keys)
    floor = g_ref.median()
    grad = (g - g_ref).abs() / torch.maximum(g_ref, floor)
    moving = [k for k, n in zip(keys, g_ref) if n >= 1e-3 * floor]
    d_ref = torch.stack([(ref_params[k] - p0[k].float()).norm() for k in moving])
    d = torch.stack([(params[k].float() - p0[k].float()).norm() for k in moving])
    change = (d - d_ref).abs() / torch.maximum(d_ref, d_ref.median())
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    worst = keys[int(grad.argmax())]
    return {"loss1_gap": loss[0], "loss_gap": max(loss), "grad_gap": float(grad.max()),
            "grad_gap_median": float(grad.median()), "change_gap": float(change.max()),
            "change_gap_median": float(change.median()), "losses": list(losses),
            "reference_losses": list(ref_losses), "worst_grad_leaf": worst,
            "leaves": len(keys), "moving_leaves": len(moving)}


def _anchors(config):
    from benchmark.reference.serve import anchors

    return anchors(config["anchors"], config["encoding"]["image_shape"])


def _quiet(_message: str) -> None:
    pass
