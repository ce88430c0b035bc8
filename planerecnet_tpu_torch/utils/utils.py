"""Console and checkpoint-path utilities.

Counterpart of ``planerecnet_tpu/utils/utils.py``. ``SavePath`` keeps the
checkpoint-name codec ``<model>_<epoch>_<iter>[.npz|_interrupt.npz]``, so
resume by name and the latest/interrupt lookups behave as in the JAX
package; the port's checkpoints are the JAX package's ``.npz`` layout.
"""

from __future__ import annotations

import math
import os
from collections import deque
from pathlib import Path
from typing import Optional

CKPT_EXT = ".npz"


class MovingAverage:
    """Windowed mean over the last ``max_window_size`` finite samples.

    Non-finite samples are ignored with a warning. The mean is computed
    lazily with ``math.fsum`` over the bounded window (once per log line),
    which avoids the drift a running add/subtract sum accumulates over a
    125k-iteration run.
    """

    def __init__(self, max_window_size: int = 1000):
        self._window: deque = deque(maxlen=max_window_size)

    def add(self, elem: float):
        if math.isfinite(elem):
            self._window.append(float(elem))
        else:
            print(f"Warning: Moving average ignored a value of {elem}")

    append = add

    def reset(self):
        self._window.clear()

    def get_avg(self) -> float:
        if not self._window:
            return 0.0
        return math.fsum(self._window) / len(self._window)

    def __str__(self):
        return str(self.get_avg())

    def __repr__(self):
        return repr(self.get_avg())

    def __len__(self):
        return len(self._window)


class ProgressBar:
    """Console progress bar string, rendered on demand."""

    def __init__(self, length: int, max_val: int):
        self.max_val = max(max_val, 1)
        self.length = length
        self.cur_val = 0

    def set_val(self, new_val: int):
        self.cur_val = min(max(new_val, 0), self.max_val)

    def is_finished(self) -> bool:
        return self.cur_val == self.max_val

    def __repr__(self):
        filled = self.length * self.cur_val // self.max_val
        return "█" * filled + "░" * (self.length - filled)

    __str__ = __repr__


def init_console():
    """ANSI escape setup on Windows; a no-op on every platform the port
    targets."""
    if os.name == "nt":  # pragma: no cover
        try:
            from colorama import init
            init()
        except ImportError:
            pass


class SavePath:
    """Checkpoint-name codec ``<model>_<epoch>_<iter>``."""

    def __init__(self, model_name: str, epoch: int, iteration: int):
        self.model_name = model_name
        self.epoch = epoch
        self.iteration = iteration

    def get_path(self, root: str = "") -> str:
        file_name = (f"{self.model_name}_{self.epoch}_{self.iteration}"
                     f"{CKPT_EXT}")
        return os.path.join(root, file_name)

    @staticmethod
    def from_str(path: str) -> "SavePath":
        file_name = os.path.basename(path)
        if file_name.endswith(CKPT_EXT):
            file_name = file_name[:-len(CKPT_EXT)]
        elif file_name.endswith(".pth"):
            file_name = file_name[:-4]
        params = file_name.split("_")
        if file_name.endswith("interrupt"):
            params = params[:-1]
        model_name = "_".join(params[:-2])
        return SavePath(model_name, int(params[-2]), int(params[-1]))

    @staticmethod
    def remove_interrupt(save_folder: str):
        for p in Path(save_folder).glob(f"*_interrupt{CKPT_EXT}"):
            p.unlink()

    @staticmethod
    def get_interrupt(save_folder: str) -> Optional[str]:
        for p in Path(save_folder).glob(f"*_interrupt{CKPT_EXT}"):
            return str(p)
        return None

    @staticmethod
    def get_latest(save_folder: str, config: str) -> Optional[str]:
        max_iter, max_name = -1, None
        for p in Path(save_folder).glob(config + "_*"):
            try:
                save = SavePath.from_str(str(p))
            except (ValueError, IndexError):
                continue
            if save.model_name == config and save.iteration > max_iter:
                max_iter = save.iteration
                max_name = str(p)
        return max_name
