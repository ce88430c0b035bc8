"""Inference runner: preprocessing + forward + post-processing.

Counterpart of ``planerecnet_tpu/runner.py``. Raw (B, H, W, 3) BGR pixels go
in; masks, boxes, classes, scores and depth come out with the keys, shapes
and meaning of the JAX package's ``postprocess_single`` plus a batch
dimension. Runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from planerecnet_tpu_torch.config import PlaneRecNetConfig
from planerecnet_tpu_torch.models.planerecnet import PlaneRecNet
from planerecnet_tpu_torch.ops.image import fast_base_transform
from planerecnet_tpu_torch.ops.postprocess import postprocess_batch
from planerecnet_tpu_torch.utils.weights import (flatten_variables,
                                                 from_jax_variables, load_npz)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device on a machine
    without one rather than running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


class PlaneRecNetRunner:
    """Owns the model and its weights and serves ``infer``.

    ``variables``: the JAX package's variables, nested or flat "/"-joined,
    numpy-valued; None builds fresh weights from ``seed``.
    """

    def __init__(self, cfg: PlaneRecNetConfig,
                 variables: Optional[Mapping] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = PlaneRecNet(cfg)
        if variables is not None:
            model.load_state_dict(
                from_jax_variables(flatten_variables(variables), model))
        self.model = model.to(self.device).eval()

    def load_weights(self, path: str):
        """Load a JAX-package ``.npz`` (weights or a full train state)."""
        self.model.load_state_dict(from_jax_variables(load_npz(path),
                                                      self.model))

    def _batch(self, images) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(images, np.float32)
                            if not isinstance(images, torch.Tensor)
                            else images)
        x = x.to(self.device, torch.float32)
        return x[None] if x.dim() == 3 else x

    @torch.no_grad()
    def infer(self, images_bgr, ori_size: Optional[Tuple[int, int]] = None
              ) -> Dict[str, torch.Tensor]:
        """Full pipeline on (B, H, W, 3) raw BGR pixels in [0, 255];
        ``ori_size`` sets the output mask/depth size (default: input)."""
        x = self._batch(images_bgr)
        preds = self.model(fast_base_transform(x))
        return postprocess_batch(preds, self.cfg, ori_size or x.shape[1:3])

    @torch.no_grad()
    def infer_normalized(self, images, ori_size: Optional[Tuple[int, int]]
                         = None) -> Dict[str, torch.Tensor]:
        """Forward + post-processing on already-normalised images."""
        x = self._batch(images)
        return postprocess_batch(self.model(x), self.cfg,
                                 ori_size or x.shape[1:3])

    @torch.no_grad()
    def forward_raw(self, images_normalized) -> Dict:
        """The raw-pred dict on already-normalised images."""
        return self.model(self._batch(images_normalized))
