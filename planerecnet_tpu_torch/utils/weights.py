"""Carry the JAX package's variables into the port's modules.

The JAX package saves its variables as a flat ``.npz`` with "/"-joined keys
(``params/backbone/layer1_0/conv2/offset_conv/kernel``,
``batch_stats/backbone/bn1/mean``). ``from_jax_variables`` maps each of them
to the port's state_dict key, which is the reference's torch key, and
converts the layout: conv kernels HWIO -> OIHW; BatchNorm ``scale``/``bias``/
``mean``/``var`` -> ``weight``/``bias``/``running_mean``/``running_var``;
GroupNorm ``scale`` -> ``weight``. ``to_jax_variables`` is its inverse, so
the port's weights, and its gradients, can be read in the JAX layout.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}
_GN = {"scale": "weight", "bias": "bias"}
_CONV_KERNELS = ("kernel", "regular_conv_kernel")


def _conv_leaf(leaf: str) -> str:
    return "weight" if leaf == "kernel" else "bias"


def _backbone_key(rest) -> Optional[str]:
    leaf = rest[-1]
    if rest[0] == "conv1":
        return "backbone.conv1.weight"
    if rest[0] == "bn1":
        return f"backbone.bn1.{_BN[leaf]}"
    m = re.fullmatch(r"layer(\d+)_(\d+)", rest[0])
    if not m:
        return None
    prefix = f"backbone.layers.{m.group(1)}.{m.group(2)}"
    sub = rest[1]
    if sub in ("bn1", "bn2", "bn3"):
        return f"{prefix}.{sub}.{_BN[leaf]}"
    if sub == "downsample_bn":
        return f"{prefix}.downsample.1.{_BN[leaf]}"
    if sub == "downsample_conv":
        return f"{prefix}.downsample.0.weight"
    if sub in ("conv1", "conv3"):
        return f"{prefix}.{sub}.weight"
    if sub == "conv2":
        return _dcn_or_conv_key(f"{prefix}.conv2", rest[2:])
    return None


def _dcn_or_conv_key(prefix: str, rest) -> Optional[str]:
    """A plain 3x3 conv (``kernel``) or a DeformableConv2d's leaves."""
    leaf = rest[-1]
    if len(rest) == 1 and leaf == "kernel":
        return f"{prefix}.weight"
    if len(rest) == 1 and leaf in ("regular_conv_kernel", "regular_conv_bias"):
        return f"{prefix}.regular_conv.{_conv_leaf(leaf[13:])}"
    if len(rest) == 2 and rest[0] in ("offset_conv", "modulator_conv"):
        return f"{prefix}.{rest[0]}.{_conv_leaf(leaf)}"
    return None


def jax_key_to_torch(key: str) -> Optional[str]:
    """The port's state_dict key for one flat JAX key, or None."""
    parts = key.split("/")
    if parts[0] not in ("params", "batch_stats") or len(parts) < 3:
        return None
    module, rest = parts[1], parts[2:]
    leaf = rest[-1]
    if module == "backbone":
        return _backbone_key(rest)
    if module == "fpn":
        m = re.fullmatch(r"(lateral_conv|fpn_conv)(\d+)", rest[0])
        if m:
            return f"fpn.{m.group(1)}s.{m.group(2)}.{_conv_leaf(leaf)}"
    elif module == "inst_head":
        m = re.fullmatch(r"(cate|kernel)_tower(\d+)_(conv|gn)", rest[0])
        if m:
            tower, i, kind = m.group(1), int(m.group(2)), m.group(3)
            if kind == "gn":
                return f"inst_head.{tower}_tower.{3 * i + 1}.{_GN[leaf]}"
            return _dcn_or_conv_key(f"inst_head.{tower}_tower.{3 * i}",
                                    rest[1:])
        if rest[0] in ("cate_pred", "kernel_pred"):
            return f"inst_head.{rest[0]}.{_conv_leaf(leaf)}"
    elif module == "mask_head":
        m = re.fullmatch(r"level(\d+)_conv(\d+)_(conv|gn)", rest[0])
        if m:
            prefix = f"mask_head.convs_all_levels.{m.group(1)}.conv{m.group(2)}"
            if m.group(3) == "conv":
                return f"{prefix}.0.weight"
            return f"{prefix}.1.{_GN[leaf]}"
        if rest[0] == "conv_pred_conv":
            return "mask_head.conv_pred.0.weight"
        if rest[0] == "conv_pred_gn":
            return f"mask_head.conv_pred.1.{_GN[leaf]}"
    elif module == "depth_decoder":
        name = rest[0]
        if name == "conv1x1":
            return f"depth_decoder.conv1x1.0.{_conv_leaf(leaf)}"
        if re.fullmatch(r"latlayer\d", name):
            return f"depth_decoder.{name}.{_conv_leaf(leaf)}"
        if name == "depth_pred":
            return f"depth_decoder.depth_pred.1.{_conv_leaf(leaf)}"
        m = re.fullmatch(r"(conv|deconv|refine_conv)(\d?)", name)
        if m and len(rest) == 3:
            conv_idx = 2 if m.group(1) == "deconv" else 1
            if rest[1] == "conv":
                return f"depth_decoder.{name}.{conv_idx}.{_conv_leaf(leaf)}"
            if rest[1] == "bn":
                return f"depth_decoder.{name}.{conv_idx + 1}.{_BN[leaf]}"
    return None


def flatten_variables(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested variables dict -> flat "/"-joined keys with numpy leaves; a
    flat dict passes through."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_variables(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a JAX-package checkpoint; of a train-state checkpoint keep only
    ``params`` and ``batch_stats``."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files
                if k.split("/", 1)[0] in ("params", "batch_stats")}


def from_jax_variables(flat: Mapping[str, np.ndarray],
                       model: nn.Module) -> Dict[str, torch.Tensor]:
    """JAX variables (flat "/" keys) -> a complete state_dict for ``model``.

    Raises on a JAX leaf with no port key, on a shape mismatch, and on a
    parameter or buffer of ``model`` left unfilled (``num_batches_tracked``
    aside, which the returned dict carries from ``model``).
    """
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    for key, value in flat.items():
        tkey = jax_key_to_torch(key)
        if tkey is None or tkey not in target:
            unmapped.append(key)
            continue
        w = np.asarray(value, dtype=np.float32)
        if key.rsplit("/", 1)[-1] in _CONV_KERNELS:
            w = np.transpose(w, (3, 2, 0, 1))           # HWIO -> OIHW
        if tuple(w.shape) != tuple(target[tkey].shape):
            raise ValueError(f"{key}: shape {w.shape} does not fit {tkey} "
                             f"{tuple(target[tkey].shape)}")
        if tkey in out:
            raise ValueError(f"{key}: {tkey} filled twice")
        out[tkey] = torch.tensor(w)
    if unmapped:
        raise KeyError(f"JAX leaves with no port key: {unmapped[:10]} "
                       f"({len(unmapped)} total)")
    unfilled = [k for k in target
                if k not in out and not k.endswith("num_batches_tracked")]
    if unfilled:
        raise KeyError(f"port keys left unfilled: {unfilled[:10]} "
                       f"({len(unfilled)} total)")
    for k in target:
        if k.endswith("num_batches_tracked"):
            out[k] = target[k]
    return out


_BN_INV = {v: k for k, v in _BN.items()}
_GN_INV = {v: k for k, v in _GN.items()}


def _bn_path(*path, leaf):
    collection = "batch_stats" if leaf.startswith("running_") else "params"
    return "/".join((collection,) + path + (_BN_INV[leaf],))


def _dcn_or_conv_path(rest):
    """Inverse of ``_dcn_or_conv_key``: the JAX leaves below the module."""
    if rest == ["weight"]:
        return ("kernel",)
    if rest[0] == "regular_conv":
        return ("regular_conv_" + _torch_conv_leaf(rest[1]),)
    if rest[0] in ("offset_conv", "modulator_conv"):
        return (rest[0], _torch_conv_leaf(rest[1]))
    raise KeyError(rest)


def _torch_conv_leaf(leaf: str) -> str:
    return {"weight": "kernel", "bias": "bias"}[leaf]


def _torch_key_to_jax(tkey: str) -> Optional[str]:
    """The flat JAX key of one port state_dict key (None for
    ``num_batches_tracked``). Raises KeyError on a key it does not know."""
    parts = tkey.split(".")
    module, leaf = parts[0], parts[-1]
    if leaf == "num_batches_tracked":
        return None

    def params(*path):
        return "/".join(("params", module) + path)

    if module == "backbone":
        if parts[1] == "conv1":
            return params("conv1", "kernel")
        if parts[1] == "bn1":
            return _bn_path(module, "bn1", leaf=leaf)
        _, _, stage, block, sub, *rest = parts
        name = f"layer{stage}_{block}"
        if sub in ("bn1", "bn2", "bn3"):
            return _bn_path(module, name, sub, leaf=leaf)
        if sub == "downsample":
            if rest[0] == "0":
                return params(name, "downsample_conv", "kernel")
            return _bn_path(module, name, "downsample_bn", leaf=leaf)
        if sub in ("conv1", "conv3"):
            return params(name, sub, "kernel")
        return params(name, "conv2", *_dcn_or_conv_path(rest))
    if module == "fpn":
        kind, i = parts[1][:-1], parts[2]
        return params(f"{kind}{i}", _torch_conv_leaf(leaf))
    if module == "inst_head":
        if parts[1] in ("cate_pred", "kernel_pred"):
            return params(parts[1], _torch_conv_leaf(leaf))
        tower = parts[1][:-len("_tower")]
        i, kind = divmod(int(parts[2]), 3)
        if kind == 0:
            return params(f"{tower}_tower{i}_conv",
                          *_dcn_or_conv_path(parts[3:]))
        return params(f"{tower}_tower{i}_gn", _GN_INV[leaf])
    if module == "mask_head":
        if parts[1] == "conv_pred":
            return (params("conv_pred_conv", "kernel") if parts[2] == "0"
                    else params("conv_pred_gn", _GN_INV[leaf]))
        name = f"level{parts[2]}_{parts[3]}"
        return (params(f"{name}_conv", "kernel") if parts[4] == "0"
                else params(f"{name}_gn", _GN_INV[leaf]))
    if module == "depth_decoder":
        name = parts[1]
        if name in ("conv1x1", "depth_pred") or name.startswith("latlayer"):
            return params(name, _torch_conv_leaf(leaf))
        conv_idx = 2 if name.startswith("deconv") else 1
        if int(parts[2]) == conv_idx:
            return params(name, "conv", _torch_conv_leaf(leaf))
        return _bn_path(module, name, "bn", leaf=leaf)
    raise KeyError(tkey)


def to_jax_variables(state: Mapping[str, torch.Tensor]
                     ) -> Dict[str, np.ndarray]:
    """Port state_dict (or any mapping of its parameter names, such as
    their gradients) -> flat "/"-keyed JAX variables, numpy f32, conv
    kernels OIHW -> HWIO. The inverse of ``from_jax_variables``."""
    out = {}
    for tkey, value in state.items():
        key = _torch_key_to_jax(tkey)
        if key is None:
            continue
        if jax_key_to_torch(key) != tkey:
            raise KeyError(f"{tkey}: no JAX key maps back to it ({key})")
        v = value.detach().cpu().float().numpy()
        if key.rsplit("/", 1)[-1] in _CONV_KERNELS:
            v = np.transpose(v, (2, 3, 1, 0))           # OIHW -> HWIO
        out[key] = np.ascontiguousarray(v)
    return out
