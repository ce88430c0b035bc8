"""Immutable configuration of the inference path.

Frozen dataclasses with the JAX package's field names and preset values
(``planerecnet_tpu/config.py``: ``PlaneRecNet_base/101/50/tiny_config``)
for the fields inference reads, so a preset means the same model in both
packages. This is a copy, not an import: the port depends on nothing of
the JAX package. Training fields (schedule, loss weights, dataset) come
with the training slice.

``compute_dtype="auto"`` resolves to float32 here; ``"bfloat16"`` is taken
when it is set explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

# ImageNet channel statistics in BGR order.
MEANS = (103.94, 116.78, 123.68)
STD = (57.38, 57.12, 58.40)


def _tup(x):
    """Recursively convert lists to tuples so dataclass fields stay hashable."""
    if isinstance(x, (list, tuple)):
        return tuple(_tup(v) for v in x)
    return x


class _FrozenBase:
    def copy(self, overrides: Optional[dict] = None):
        """A copy with the fields in ``overrides`` replaced."""
        overrides = {k: _tup(v) for k, v in (overrides or {}).items()}
        return replace(self, **overrides)


@dataclass(frozen=True)
class BackboneConfig(_FrozenBase):
    """ResNet backbone: (layers, dcn_layers, dcn_interval) pick the blocks
    that carry a deformable conv2 (see ``models/backbone.py::_stage_plan``)."""

    layers: Tuple[int, ...] = ()
    dcn_layers: Tuple[int, ...] = (0, 0, 0, 0)
    dcn_interval: int = 1
    atrous_layers: Tuple[int, ...] = ()
    selected_layers: Tuple[int, ...] = ()


resnet101_backbone = BackboneConfig(layers=(3, 4, 23, 3),
                                    selected_layers=tuple(range(3, 7)))
resnet101_dcn_inter3_backbone = resnet101_backbone.copy(dict(
    dcn_layers=(0, 4, 23, 3), dcn_interval=3))
resnet50_dcnv2_backbone = resnet101_backbone.copy(dict(
    layers=(3, 4, 6, 3), dcn_layers=(0, 4, 6, 3)))


@dataclass(frozen=True)
class FPNConfig(_FrozenBase):
    selected_layers: Tuple[int, ...] = tuple(range(0, 4))
    start_level: Optional[int] = None
    num_features: int = 256
    interpolation_mode: str = "bilinear"
    high_level_mode: Optional[str] = None  # 'original' | None
    relu_pred_layers: bool = True


fpn_base = FPNConfig()


@dataclass(frozen=True)
class DepthConfig(_FrozenBase):
    selected_layers: Tuple[int, ...] = tuple(range(0, 4))
    # Decoder width at the coarsest level, halved down the decoder.
    num_features: int = 256


@dataclass(frozen=True)
class SOLOv2Config(_FrozenBase):
    num_kernels: int = 256
    masks_in_features: Tuple[str, ...] = ("p2", "p3", "p4", "p5")
    masks_channels: int = 128
    num_masks: int = 256
    instance_channels: int = 512
    fpn_instance_strides: Tuple[int, ...] = (8, 8, 16, 32, 32)
    num_grids: Tuple[int, ...] = (40, 36, 24, 16, 12)
    num_instance_convs: int = 4
    use_dcn_in_instance: bool = False
    nms_pre: int = 500
    score_thr: float = 0.1
    nms_type: str = "matrix"
    mask_thr: float = 0.1
    update_thr: float = 0.15
    nms_kernel: str = "gaussian"
    nms_sigma: float = 2.0
    top_k: int = 100
    focal_loss_init_pi: float = 0.01
    # Fixed candidate capacity of the post-processing (>= nms_pre); more
    # candidates than this sets ``candidates_clipped``.
    max_candidates: int = 512


solov2_base = SOLOv2Config()

solov2_light = SOLOv2Config(
    num_kernels=128,
    masks_in_features=("p2", "p3", "p4", "p5"),
    masks_channels=128,
    num_masks=128,
    instance_channels=256,
    fpn_instance_strides=(8, 8, 16, 32),
    num_grids=(40, 36, 24, 16),
    num_instance_convs=3,
)


@dataclass(frozen=True)
class PlaneRecNetConfig(_FrozenBase):
    name: str = "PlaneRecNet_base"
    num_classes: int = 2   # background + "plane"
    backbone: BackboneConfig = resnet101_backbone.copy(
        dict(selected_layers=tuple(range(2, 4))))
    fpn: FPNConfig = fpn_base.copy(dict(start_level=0,
                                        high_level_mode="original"))
    depth: DepthConfig = DepthConfig()
    solov2: SOLOv2Config = solov2_base
    # "float32", "bfloat16", or "auto" (= float32).
    compute_dtype: str = "auto"


PlaneRecNet_base_config = PlaneRecNetConfig()

PlaneRecNet_101_config = PlaneRecNet_base_config.copy(dict(
    name="PlaneRecNet_101",
    backbone=resnet101_dcn_inter3_backbone.copy(
        dict(selected_layers=tuple(range(2, 4)))),
    fpn=fpn_base.copy(dict(start_level=0, high_level_mode=None)),
    solov2=solov2_light,
))

PlaneRecNet_50_config = PlaneRecNet_101_config.copy(dict(
    name="PlaneRecNet_50",
    backbone=resnet50_dcnv2_backbone.copy(
        dict(selected_layers=tuple(range(2, 4)))),
))

# PlaneRecNet-50's architecture at smoke-test widths and depth.
PlaneRecNet_tiny_config = PlaneRecNet_50_config.copy(dict(
    name="PlaneRecNet_tiny",
    backbone=PlaneRecNet_50_config.backbone.copy(dict(
        layers=(1, 1, 1, 1), dcn_layers=(0, 1, 1, 1), dcn_interval=1)),
    fpn=PlaneRecNet_50_config.fpn.copy(dict(num_features=32)),
    depth=PlaneRecNet_50_config.depth.copy(dict(num_features=32)),
    solov2=PlaneRecNet_50_config.solov2.copy(dict(
        num_kernels=32, num_masks=32, masks_channels=32,
        instance_channels=32, num_instance_convs=1,
        num_grids=(8, 8, 4, 4),
        nms_pre=16, top_k=8, max_candidates=32)),
))


_CONFIGS = {
    "PlaneRecNet_base_config": PlaneRecNet_base_config,
    "PlaneRecNet_101_config": PlaneRecNet_101_config,
    "PlaneRecNet_50_config": PlaneRecNet_50_config,
    "PlaneRecNet_tiny_config": PlaneRecNet_tiny_config,
}


def get_cfg(config_name: str) -> PlaneRecNetConfig:
    """Look a preset up by name (``"PlaneRecNet_50_config"``)."""
    if config_name not in _CONFIGS:
        raise KeyError(
            f"Unknown config '{config_name}'. Available: {sorted(_CONFIGS)}")
    return _CONFIGS[config_name]
