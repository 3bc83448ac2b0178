"""Checkpointing: step-level save/restore of the training state (PyTorch),
counterpart of ssdseglib_tpu/checkpoint.py.

The reference persists only a single post-training whole-model `.keras`
save (reference notebook 03 cell 17) — a crash loses all 105 epochs.
Here training state (params, BN stats, optimizer state, step) checkpoints
at step granularity with retention, and restore resumes mid-run.

`Checkpointer` has the JAX package's surface on ``torch.save`` /
``torch.load``: one file per step, written under a temporary name and
renamed, so a reader never sees half a file; the oldest steps are pruned.
Unlike the Orbax manager it writes synchronously (``save`` returns when the
file is in place), so `wait_until_finished` has nothing to wait for.  A state
replicated on a data-parallel mesh (``state.mesh``) is written by rank 0
alone, and no rank returns from `save` before the file is in place; every
rank can `restore`.

`save_params_npz` / `load_params_npz` read and write the JAX package's flat
``.npz`` names (``params/<module>/.../kernel``, HWIO layout) through
``weights.py``: a file written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ssdseglib_torch import weights as weights_lib
from ssdseglib_torch.parallel import mesh as mesh_lib

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _state_tensors(state: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """The four tensor mappings of a ``train.TrainState``."""
    return {
        "params": state.params,
        "batch_stats": state.batch_stats,
        "mu": state.opt_state.mu,
        "nu": state.opt_state.nu,
    }


class Checkpointer:
    """Step-level checkpoints of a ``train.TrainState`` in one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        steps = (_STEP_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in steps if m)

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` as step ``step`` (values copied to the host, in
        their dtypes: a bfloat16 ``mu`` stays bfloat16) and prune the oldest
        steps beyond ``max_to_keep``.  On a mesh only rank 0 writes, and
        every rank waits for it (an all_reduce read on the host)."""
        mesh = getattr(state, "mesh", None)
        if mesh is None:
            self._write(step, state)
            return
        group = mesh_lib.mesh_group(mesh)
        if dist.get_rank(group) == 0:
            self._write(step, state)
        fence = torch.zeros(1, device=mesh_lib.local_device(mesh))
        mesh_lib.all_reduce_(fence, group).item()

    def _write(self, step: int, state: Any) -> None:
        payload: Dict[str, Any] = {"step": int(state.step)}
        for name, tensors in _state_tensors(state).items():
            payload[name] = {k: v.detach().to("cpu", copy=True).contiguous()
                             for k, v in tensors.items()}
        tmp = f"{self._path(step)}.tmp.{os.getpid()}"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, self._path(step))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """A new state shaped like ``state_template`` (same keys, shapes,
        dtypes, devices and memory layouts, and its mesh) holding the saved
        values of ``step`` (the latest when None)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        restored = {}
        for name, template in _state_tensors(state_template).items():
            saved = payload[name]
            if saved.keys() != template.keys():
                raise ValueError(
                    f"checkpoint step {step}: {name} holds other tensors than the template "
                    f"({sorted(saved.keys() ^ template.keys())[:4]} ...)"
                )
            restored[name] = {}
            for key, like in template.items():
                value = saved[key]
                if value.shape != like.shape or value.dtype != like.dtype:
                    raise ValueError(
                        f"checkpoint step {step}: {name}/{key} is {tuple(value.shape)} "
                        f"{value.dtype}, the template {tuple(like.shape)} {like.dtype}"
                    )
                restored[name][key] = torch.empty_like(like).copy_(value)
        opt_state = type(state_template.opt_state)(mu=restored["mu"], nu=restored["nu"])
        return dataclasses.replace(
            state_template, step=int(payload["step"]), params=restored["params"],
            batch_stats=restored["batch_stats"], opt_state=opt_state)

    def close(self) -> None:
        """Nothing is held open."""


def save_params_npz(path: str, variables: Mapping[str, torch.Tensor]) -> None:
    """Flat .npz export of a ``state_dict``-shaped mapping (parameters and
    BatchNorm statistics) under the JAX package's names and layouts."""
    np.savez(path, **weights_lib.flatten(weights_lib.to_flax_variables(variables)))


def load_params_npz(
    path: str, template: Optional[Mapping[str, torch.Tensor]] = None
) -> "Dict[str, torch.Tensor]":
    """A ``state_dict`` from a flat .npz written by `save_params_npz` of
    either package; with a ``template`` ``state_dict`` the keys and shapes
    are validated against it and the values take its dtypes."""
    with np.load(path) as data:
        state = weights_lib.from_flax_variables({k: data[k] for k in data.files})
    if template is None:
        return state
    for key, like in template.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key not in state:
            raise KeyError(f"{path} has no value for {key}")
        if state[key].shape != like.shape:
            raise ValueError(f"{key}: shape {tuple(state[key].shape)} != {tuple(like.shape)}")
        state[key] = state[key].to(like.dtype)
    return state
