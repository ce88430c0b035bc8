"""Reference PyTorch checkpoints (``.pth``) -> the port's model.

Counterpart of ``planerecnet_tpu/utils/torch_convert.py``. The port's
modules carry the reference's names, so its state-dict keys are the
reference's and a reference ``state_dict`` loads without remapping. What
this module adds is the JAX converter's completeness check:
``convert_state_dict`` raises ``KeyError`` for a model key the checkpoint
lacks or a checkpoint key the model lacks (BatchNorm's
``num_batches_tracked`` excepted, as there), and ``ValueError`` for a
shape that differs. ``convert_backbone_imagenet`` loads a torchvision-style
ImageNet ResNet into the backbone with the reference's key remap
``layer{i}.`` -> ``layers.{i-1}.`` and ``strict=False`` semantics.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch
from torch import nn

_IGNORED = "num_batches_tracked"


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` file's state dict, on the CPU (a saved module gives its
    ``state_dict()``)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return dict(sd)


def _as_tensor(value, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(value).detach().cpu()
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"shape {tuple(t.shape)} where the model has "
                         f"{tuple(like.shape)}")
    return t.to(like.dtype).clone()


def convert_state_dict(state_dict: Mapping, model: nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """The reference ``state_dict`` (tensors or numpy arrays) as the
    port's: every model key from the checkpoint, cast to the model's
    dtypes, or ``KeyError`` (see the module note)."""
    own = model.state_dict()
    missing = [k for k in own if k not in state_dict
               and not k.endswith(_IGNORED)]
    if missing:
        raise KeyError(f"checkpoint lacks model keys: {missing[:10]} "
                       f"({len(missing)} total)")
    unused = [k for k in state_dict if k not in own
              and not k.endswith(_IGNORED)]
    if unused:
        raise KeyError(f"unused checkpoint keys: {unused[:10]} "
                       f"({len(unused)} total)")
    out = {}
    for key, like in own.items():
        if key not in state_dict:
            out[key] = like.detach().clone()
            continue
        try:
            out[key] = _as_tensor(state_dict[key], like)
        except ValueError as e:
            raise ValueError(f"{key}: {e}") from None
    return out


def convert_backbone_imagenet(state_dict: Mapping, model: nn.Module
                              ) -> Dict[str, torch.Tensor]:
    """The model's state dict with its backbone taken from a torchvision
    ImageNet ResNet: ``layer{i}.`` becomes ``backbone.layers.{i-1}.``;
    checkpoint keys the backbone lacks (``fc.*``, the DCN blocks'
    ``conv2.weight``) are ignored, and every other entry keeps the model's
    value."""
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for key, value in state_dict.items():
        m = re.match(r"layer(\d)\.(.*)", key)
        if m:
            key = f"layers.{int(m.group(1)) - 1}.{m.group(2)}"
        key = "backbone." + key
        if key in out:
            try:
                out[key] = _as_tensor(value, out[key])
            except ValueError as e:
                raise ValueError(f"{key}: {e}") from None
    return out
