"""Checkpoints as flat ``.npz`` files, readable by both packages.

Weights are saved as the JAX package saves them (``params/...`` and
``batch_stats/...`` with "/"-joined keys, HWIO kernels), so either
package's runner loads the other's weights. A train state adds what a
resume needs: the optimizer's state, Adam's under ``adam/{exp_avg,
exp_avg_sq,step}/<port name>`` and SGD's under ``sgd/momentum_buffer/
<port name>``, the counters ``step`` and ``updates`` and the ``seed`` of
the step's random numbers. Files are written
atomically: a temporary file in the same directory, then ``os.replace``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from planerecnet_tpu_torch.utils.weights import (from_jax_variables,
                                                 load_npz, to_jax_variables)


def _prefix(optimizer: torch.optim.Optimizer) -> str:
    return "sgd" if isinstance(optimizer, torch.optim.SGD) else "adam"


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
    """Weights, the optimizer's state and the step counters of a
    ``TrainState``."""
    flat = to_jax_variables(state.model.state_dict())
    names = {p: n for n, p in state.model.named_parameters()}
    pre = _prefix(state.optimizer)
    for p, st in state.optimizer.state.items():
        for key in sorted(k for k in st if k != "step"):
            flat[f"{pre}/{key}/{names[p]}"] = st[key].cpu().numpy()
        if "step" in st:
            flat[f"{pre}/step/{names[p]}"] = np.asarray(float(st["step"]))
    flat["step"] = np.asarray(state.step)
    flat["updates"] = np.asarray(state.updates)
    flat["seed"] = np.asarray(state.seed)
    return _atomic_savez(path, flat)


def load_train_state(path: str, state) -> None:
    """Restore a ``TrainState`` in place from ``save_train_state``'s file:
    weights, the optimizer's state (none is saved before the first
    update), the counters and the seed."""
    load_weights(path, state.model)
    pre = _prefix(state.optimizer)
    with np.load(path, allow_pickle=False) as data:
        state.step = int(data["step"])
        state.updates = int(data["updates"])
        state.seed = int(data["seed"])
        state.optimizer.state.clear()
        saved: Dict[str, Dict[str, str]] = {}
        for f in data.files:
            parts = f.split("/", 2)
            if len(parts) == 3 and parts[0] == pre:
                saved.setdefault(parts[2], {})[parts[1]] = f
        for name, p in state.model.named_parameters():
            if name not in saved:
                continue
            st = {key: torch.from_numpy(data[f]).to(p.device)
                  for key, f in saved[name].items() if key != "step"}
            if "step" in saved[name]:
                st["step"] = torch.tensor(float(data[saved[name]["step"]]))
            state.optimizer.state[p] = st
