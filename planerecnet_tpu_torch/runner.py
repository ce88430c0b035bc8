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
from planerecnet_tpu_torch.utils import checkpoint, torch_convert
from planerecnet_tpu_torch.utils.timer import span
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

    @classmethod
    def around(cls, cfg: PlaneRecNetConfig, model: PlaneRecNet
               ) -> "PlaneRecNetRunner":
        """A runner over an existing model, shared, not copied (the train
        CLI's validation); the caller puts the model in eval mode."""
        runner = cls.__new__(cls)
        runner.cfg = cfg
        runner.device = next(model.parameters()).device
        runner.model = model
        return runner

    def init_weights(self, backbone_path: Optional[str] = None):
        """Keep the fresh weights, and with ``backbone_path`` load a
        torchvision ImageNet ResNet ``.pth`` into the backbone."""
        if backbone_path:
            self.model.load_state_dict(torch_convert.convert_backbone_imagenet(
                torch_convert.load_pth(backbone_path), self.model))

    def save_weights(self, path: str) -> str:
        """Save the weights as the JAX package does (``.npz``); returns the
        path written."""
        return checkpoint.save_weights(path, self.model)

    def load_weights(self, path: str):
        """Load a reference ``.pth`` (``utils/torch_convert.py``) or a
        ``.npz`` of either package (weights or a full train state)."""
        if path.endswith(".pth"):
            state = torch_convert.convert_state_dict(
                torch_convert.load_pth(path), self.model)
        else:
            state = from_jax_variables(load_npz(path), self.model)
        self.model.load_state_dict(state)

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
        with span("runner.request"):
            with span("runner.upload"):
                x = self._batch(images_bgr)
            with span("runner.forward"):
                preds = self.model(fast_base_transform(x))
            with span("runner.postprocess"):
                return postprocess_batch(preds, self.cfg,
                                         ori_size or x.shape[1:3])

    @torch.no_grad()
    def infer_normalized(self, images, ori_size: Optional[Tuple[int, int]]
                         = None) -> Dict[str, torch.Tensor]:
        """Forward + post-processing on already-normalised images."""
        x = self._batch(images)
        return postprocess_batch(self.model(x), self.cfg,
                                 ori_size or x.shape[1:3])

    @torch.no_grad()
    def infer_normalized_with_gt_iou(
            self, images, gt_masks, ori_size: Optional[Tuple[int, int]] = None
    ) -> Dict[str, torch.Tensor]:
        """Forward + post-processing on normalised (B, H, W, 3) images,
        and the IoU of every predicted mask with every padded GT mask
        (B, N, H, W) on the device: returns the outputs without
        ``pred_masks`` and with ``gt_mask_iou`` (B, top_k, N), so that
        only that matrix comes back to the host. Exact: the masks are
        binary, so the f32 products sum integers below 2^24, and the
        division is the host formula's (``evaluation.mask_iou``)."""
        x = self._batch(images)
        out = postprocess_batch(self.model(x), self.cfg,
                                ori_size or x.shape[1:3])
        b = x.shape[0]
        gm = torch.as_tensor(np.asarray(gt_masks, np.float32)
                             if not isinstance(gt_masks, torch.Tensor)
                             else gt_masks).to(self.device, torch.float32)
        gm = gm.reshape(b, gm.shape[1], -1)
        pm = out.pop("pred_masks")
        pm = pm.to(torch.float32).reshape(b, pm.shape[1], -1)
        inter = torch.bmm(pm, gm.transpose(1, 2))
        union = pm.sum(-1)[..., None] + gm.sum(-1)[:, None, :] - inter
        out["gt_mask_iou"] = torch.where(
            union > 0, inter / union.clamp_min(1e-12),
            torch.zeros((), device=self.device))
        return out

    @torch.no_grad()
    def forward_raw(self, images_normalized) -> Dict:
        """The raw-pred dict on already-normalised images."""
        return self.model(self._batch(images_normalized))

    def warmup(self, shape: Optional[Tuple[int, int]] = None):
        """One request of a zero frame at ``shape`` (default: ``max_size``
        square), waited for."""
        h, w = shape or (self.cfg.max_size, self.cfg.max_size)
        self.infer(np.zeros((1, h, w, 3), np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
