"""Checkpoints as flat ``.npz`` files, readable by both packages.

Weights are saved as the JAX package saves them (``params/...`` and
``batch_stats/...`` with "/"-joined keys, HWIO kernels), so either
package's runner loads the other's weights. A train state adds what a
resume needs: Adam's state under ``adam/{exp_avg,exp_avg_sq,step}/<port
name>``, the counters ``step`` and ``updates`` and the ``seed`` of the
step's random numbers. Files are written
atomically: a temporary file in the same directory, then ``os.replace``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from planerecnet_tpu_torch.utils.weights import (from_jax_variables,
                                                 load_npz, to_jax_variables)

_MOMENTS = ("exp_avg", "exp_avg_sq")


def _atomic_savez(path: str, flat: Dict[str, np.ndarray]) -> str:
    path = path if path.endswith(".npz") else path + ".npz"
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path


def save_weights(path: str, model: torch.nn.Module) -> str:
    """Save params and batch_stats in the JAX package's layout; returns
    the path written (``.npz`` appended where missing)."""
    return _atomic_savez(path, to_jax_variables(model.state_dict()))


def load_weights(path: str, model: torch.nn.Module) -> None:
    """Load a checkpoint of either package into ``model``."""
    model.load_state_dict(from_jax_variables(load_npz(path), model))


def save_train_state(path: str, state) -> str:
    """Weights, Adam's moments and the step counters of a ``TrainState``."""
    flat = to_jax_variables(state.model.state_dict())
    names = {p: n for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for moment in _MOMENTS:
            flat[f"adam/{moment}/{names[p]}"] = st[moment].cpu().numpy()
        flat[f"adam/step/{names[p]}"] = np.asarray(float(st["step"]))
    flat["step"] = np.asarray(state.step)
    flat["updates"] = np.asarray(state.updates)
    flat["seed"] = np.asarray(state.seed)
    return _atomic_savez(path, flat)


def load_train_state(path: str, state) -> None:
    """Restore a ``TrainState`` in place from ``save_train_state``'s file:
    weights, Adam's state (none is saved before the first update), the
    counters and the seed."""
    load_weights(path, state.model)
    with np.load(path, allow_pickle=False) as data:
        state.step = int(data["step"])
        state.updates = int(data["updates"])
        state.seed = int(data["seed"])
        state.optimizer.state.clear()
        for name, p in state.model.named_parameters():
            key = f"adam/exp_avg/{name}"
            if key not in data.files:
                continue
            state.optimizer.state[p] = {
                "step": torch.tensor(float(data[f"adam/step/{name}"])),
                **{m: torch.from_numpy(data[f"adam/{m}/{name}"]).to(p.device)
                   for m in _MOMENTS}}
