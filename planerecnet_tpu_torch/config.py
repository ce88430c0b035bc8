"""Immutable configuration of the inference and training paths.

Frozen dataclasses with the JAX package's field names and preset values
(``planerecnet_tpu/config.py``: ``PlaneRecNet_base/101/50/tiny_config``
and the dataset presets) for the fields the port reads, so a preset means
the same model, the same data and the same training recipe in both
packages. This is a copy, not an import: the port depends on nothing of
the JAX package.

``compute_dtype="auto"`` resolves to float32 here; ``"bfloat16"`` is taken
when it is set explicitly. ``remat_backbone="auto"`` has the JAX rule's
form with the H100's own fitting point (``models/planerecnet.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional, Tuple

# ImageNet channel statistics in BGR order.
MEANS = (103.94, 116.78, 123.68)
STD = (57.38, 57.12, 58.40)

# Instance colours of the visualisations, RGB (the JAX package's COLORS).
COLORS = (
    (244, 67, 54), (233, 30, 99), (156, 39, 176), (103, 58, 183),
    (63, 81, 181), (33, 150, 243), (3, 169, 244), (0, 188, 212),
    (0, 150, 136), (76, 175, 80), (139, 195, 74), (205, 220, 57),
    (255, 235, 59), (255, 193, 7), (255, 152, 0), (255, 87, 34),
    (121, 85, 72), (158, 158, 158), (96, 125, 139),
)

PLANE_CLASSES = ("plane",)
PLANE_LABEL_MAP = {1: 1}


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
class DatasetConfig(_FrozenBase):
    """A dataset preset: where its splits are, what its annotations carry
    and how its depth PNGs scale to metres. The loss's "ScanNet" branch
    tests a name no preset has, so it never fires, in either package."""

    name: str = "PlaneAnnoDataset"
    train_images: str = ""
    train_info: str = ""
    valid_images: str = ""
    valid_info: str = ""
    eval_images: str = ""
    eval_info: str = ""
    has_gt: bool = True
    has_pos: bool = True
    class_names: Tuple[str, ...] = PLANE_CLASSES
    # Depth png value -> metres.
    depth_resolution: Optional[float] = None
    min_depth: Optional[float] = None
    max_depth: Optional[float] = None
    # Scale applied to the camera intrinsics when back-projecting depth.
    scale_factor: Optional[float] = None
    # category_id -> label; None = identity over class_names.
    label_map: Optional[Tuple[Tuple[int, int], ...]] = tuple(
        PLANE_LABEL_MAP.items())


dataset_base = DatasetConfig()
scannet_dataset = dataset_base.copy(dict(
    name="ScanNetDataset",
    train_images="./scannet/scans/",
    train_info="./scannet/scannet_train.json",
    valid_images="./scannet/scans/",
    valid_info="./scannet/scannet_val.json",
    eval_images="./scannet/scans/",
    eval_info="./scannet/scannet_eval.json",
    depth_resolution=1 / 1000,
    min_depth=1 / 1000,
    max_depth=40.0,
    scale_factor=1.0,
))
nyu_eval = dataset_base.copy(dict(
    name="NYUDataset",
    eval_images="./NYU/nyu_images/",
    eval_info="./NYU/nyu_eval.json",
    scale_factor=1.0,
    min_depth=1 / 1000,
    max_depth=40.0,
    has_pos=False,
    depth_resolution=1 / 65535.0 * 9.99547,
))
S2D3DS_dataset = dataset_base.copy(dict(
    name="S2D3DSDataset",
    train_images="./S2D3DS/images/",
    train_info="./S2D3DS/s2d3ds_train.json",
    valid_images="./S2D3DS/images_val/",
    valid_info="./S2D3DS/s2d3ds_val.json",
    depth_resolution=1 / 512,
    min_depth=1 / 512,
    max_depth=40.0,
    scale_factor=0.5,
))


@dataclass(frozen=True)
class AugmentConfig(_FrozenBase):
    """Train-time augmentation switches (``data/augmentations.py``)."""

    photometric_distort: bool = True
    random_mirror: bool = True
    random_flip: bool = True
    random_rot90: bool = False
    motion_blur: bool = False
    gaussian_noise: bool = False


@dataclass(frozen=True)
class TransformConfig(_FrozenBase):
    """Input normalisation recipe of the host-side transforms."""

    channel_order: str = "RGB"
    normalize: bool = True
    subtract_means: bool = False
    to_float: bool = False


@dataclass(frozen=True)
class BackboneConfig(_FrozenBase):
    """ResNet backbone: (layers, dcn_layers, dcn_interval) pick the blocks
    that carry a deformable conv2 (see ``models/backbone.py::_stage_plan``)."""

    name: str = "Base Backbone"
    layers: Tuple[int, ...] = ()
    dcn_layers: Tuple[int, ...] = (0, 0, 0, 0)
    dcn_interval: int = 1
    atrous_layers: Tuple[int, ...] = ()
    # The ImageNet weights' file name; the train CLI looks for it in
    # ``--backbone_folder``.
    path: str = "path/to/pretrained/weights"
    transform: TransformConfig = TransformConfig()
    selected_layers: Tuple[int, ...] = ()
    # The stem and the first ``frozen_stages`` ResNet stages take no
    # gradient and run without an autograd record (mmdet's
    # ``frozen_stages``: 1 freezes the stem and the 256-channel stage); 0
    # freezes nothing.
    frozen_stages: int = 0


resnet101_backbone = BackboneConfig(name="ResNet101",
                                    layers=(3, 4, 23, 3),
                                    path="resnet101_reducedfc.pth",
                                    selected_layers=tuple(range(3, 7)))
resnet101_dcn_inter3_backbone = resnet101_backbone.copy(dict(
    name="ResNet101_DCN_Interval3", dcn_layers=(0, 4, 23, 3),
    dcn_interval=3))
resnet50_dcnv2_backbone = resnet101_backbone.copy(dict(
    name="ResNet50_DCNv2", path="resnet50-19c8e357.pth",
    layers=(3, 4, 6, 3), dcn_layers=(0, 4, 6, 3)))


@dataclass(frozen=True)
class FPNConfig(_FrozenBase):
    selected_layers: Tuple[int, ...] = tuple(range(0, 4))
    start_level: Optional[int] = None
    num_features: int = 256
    interpolation_mode: str = "bilinear"
    high_level_mode: Optional[str] = None  # 'original' | None
    relu_pred_layers: bool = True
    # False: PlaneRecNet's fine-to-coarse running sum; True: the classic
    # top-down pathway (each coarser level resized up and added to the
    # next finer lateral), as mmdetection's FPN.
    top_down: bool = False


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
    # Per level, the range of sqrt(box area) in input pixels that the
    # level is assigned, and the centre-region shrink of the assignment.
    fpn_scale_ranges: Tuple[Tuple[int, int], ...] = (
        (1, 96), (48, 192), (96, 384), (192, 768), (384, 2048))
    num_grids: Tuple[int, ...] = (40, 36, 24, 16, 12)
    num_instance_convs: int = 4
    sigma: float = 0.2
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
    # Instance levels: p2 halved, p3, p4, p5 and, with 5, p6 resized to
    # p5's size (SOLOv2's ``split_feats``). Each needs its grid, stride and
    # scale range above.
    num_instance_levels: int = 4


solov2_base = SOLOv2Config()

solov2_light = SOLOv2Config(
    num_kernels=128,
    masks_in_features=("p2", "p3", "p4", "p5"),
    masks_channels=128,
    num_masks=128,
    instance_channels=256,
    fpn_instance_strides=(8, 8, 16, 32),
    fpn_scale_ranges=((1, 128), (64, 256), (128, 512), (256, 2048)),
    num_grids=(40, 36, 24, 16),
    num_instance_convs=3,
)


@dataclass(frozen=True)
class PlaneRecNetConfig(_FrozenBase):
    name: str = "PlaneRecNet_base"
    dataset: DatasetConfig = scannet_dataset
    num_classes: int = 2   # background + "plane"
    augment: AugmentConfig = AugmentConfig()

    # Training schedule: linear warm-up from ``lr_warmup_init`` to ``lr``
    # over ``lr_warmup_until`` updates, then ``lr * gamma**k`` after the
    # k-th of ``lr_steps``.
    max_iter: int = 125000
    lr_steps: Tuple[int, ...] = (62500, 100000)
    lr: float = 1e-4
    lr_warmup_init: float = 1e-6
    lr_warmup_until: int = 2000
    gamma: float = 0.1
    # Every BatchNorm uses its running statistics in training too.
    freeze_bn: bool = False
    # (iteration, {field: value}) pairs the train CLI applies from that
    # iteration on.
    delayed_settings: Tuple = ()

    # The optimizer: "adam" (0.9, 0.999, eps 1e-8, no weight decay) or
    # "sgd" with ``momentum`` and ``weight_decay``; with ``clip_grad_norm``
    # the gradients' global L2 norm is clipped to it before the update.
    optimizer: str = "adam"
    momentum: float = 0.9
    weight_decay: float = 0.0
    clip_grad_norm: Optional[float] = None

    # Loss weights and switches.
    dice_weight: float = 3.0
    focal_weight: float = 1.0
    depth_weight: float = 5.0
    use_lava_loss: bool = False
    use_plane_loss: bool = False
    lava_weight: float = 0.5
    pln_weight: float = 1.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25

    # Fixed capacities of the loss: GT instances per image, positive
    # (cell, instance) slots per image and level, VNL triplets per plane,
    # and the planes per image the VNL loss samples (valid ones first).
    max_instances: int = 32
    max_positives: int = 128
    vnl_samples: int = 512
    vnl_max_planes: int = 16

    # Boxes narrower or lower than this share of the input are dropped.
    discard_box_width: float = 4 / 640
    discard_box_height: float = 4 / 640
    # Square input side of the host-side transforms.
    max_size: int = 640
    # The training wire: True ships the augmented image as u8 BGR and
    # normalises it on the device (photometric values clipped and rounded
    # to the u8 range); False ships the normalised f32 image.
    device_normalize: bool = True
    # True ships only the valid instance slots' bit-packed masks
    # (``masks_sparse``, ``mask_slots``); False all slots
    # (``masks_packed``).
    wire_sparse_masks: bool = True

    backbone: BackboneConfig = resnet101_backbone.copy(
        dict(selected_layers=tuple(range(2, 4))))
    fpn: FPNConfig = fpn_base.copy(dict(start_level=0,
                                        high_level_mode="original"))
    depth: DepthConfig = DepthConfig()
    # False builds no depth decoder: the forward returns no ``depth_pred``,
    # the loss has no depth term and the batch needs no ``depth``.
    use_depth: bool = True
    solov2: SOLOv2Config = solov2_base
    # "float32", "bfloat16", or "auto" (= float32).
    compute_dtype: str = "auto"
    # True lets cuDNN's convolutions round their inputs to TF32 on the
    # card (PyTorch's default); False holds the forward, and the training
    # step's backward, to full f32 convolutions and matrix products
    # (``models/planerecnet.py::tf32_switches``).
    allow_tf32: bool = True
    # The dice/lava loss: "auto" and "on" through ``ops.dice_lava``'s
    # kernels (their plain version on the CPU), "off" through the plain
    # PyTorch composition on either device.
    fused_loss_kernel: str = "auto"
    # Recompute each backbone bottleneck's activations in the backward
    # instead of storing them: True, False, or "auto", which remats only
    # when gradients flow and the input would not fit the card without
    # it (``models/planerecnet.py::resolve_remat``).
    remat_backbone: object = "auto"


PlaneRecNet_base_config = PlaneRecNetConfig()

PlaneRecNet_101_config = PlaneRecNet_base_config.copy(dict(
    name="PlaneRecNet_101",
    backbone=resnet101_dcn_inter3_backbone.copy(
        dict(selected_layers=tuple(range(2, 4)))),
    fpn=fpn_base.copy(dict(start_level=0, high_level_mode=None)),
    solov2=solov2_light,
    use_lava_loss=True,
    use_plane_loss=True,
    lava_weight=1.0,
    pln_weight=1.0,
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
    max_instances=4, max_positives=16, vnl_samples=32,
    remat_backbone=False,
))


# SOLOv2-R101-DCN (WXinlong/SOLO, configs/solov2/
# solov2_r101_dcn_fpn_8gpu_3x.py): PlaneRecNet's instance branch without
# its depth decoder, in the heaviest published form. ResNet-101 with DCNv2
# in every block of stages 3-5, the stem and stage 2 frozen, BatchNorm on
# its running statistics; an FPN of 256 channels, P2-P6; five instance
# levels, whose two towers of 4 DCNv2 convs of 512 channels each
# (GroupNorm 32) predict 80 classes and 256 dynamic kernels; dice (3) and
# focal (1) losses; SGD with momentum 0.9, weight decay 1e-4, gradients
# clipped at 35. The learning rate is the published 0.01 at 16 images
# scaled to 8 cards x 8 images (0.04), its steps at epochs 27 and 33 of
# 36 over COCO train2017's 118,287 images (1,849 updates an epoch).
SOLOv2_R101_DCN_config = PlaneRecNet_base_config.copy(dict(
    name="SOLOv2_R101_DCN",
    num_classes=80,   # labels 0-79; the background is label 80, no logit
    backbone=resnet101_backbone.copy(dict(
        name="ResNet101_DCNv2", dcn_layers=(0, 4, 23, 3), dcn_interval=1,
        selected_layers=tuple(range(0, 4)), frozen_stages=1)),
    fpn=fpn_base.copy(dict(start_level=0, high_level_mode="original",
                           interpolation_mode="nearest",
                           relu_pred_layers=False, top_down=True)),
    solov2=solov2_base.copy(dict(use_dcn_in_instance=True,
                                 num_instance_levels=5)),
    use_depth=False,
    freeze_bn=True,
    dice_weight=3.0,
    focal_weight=1.0,
    optimizer="sgd",
    momentum=0.9,
    weight_decay=1e-4,
    clip_grad_norm=35.0,
    lr=0.04,
    lr_warmup_init=0.04 * 0.01,
    lr_warmup_until=500,
    lr_steps=(27 * 1849, 33 * 1849),
    max_iter=36 * 1849,
    # Up to 20 instances an image (the benchmark's traffic), and room for
    # every one of their positives: at most 9 cells an instance a level.
    max_instances=20,
    max_positives=180,
    max_size=1344,
    remat_backbone=False,
    # Full f32, as the published recipe trained (V100s). With TF32
    # convolutions the first step's gradient of a tower's offset or
    # modulator conv came up to 13% of its norm away from a full-f32
    # reference on an H100; in full f32, at most 0.2%.
    allow_tf32=False,
))


_CONFIGS = {
    "PlaneRecNet_base_config": PlaneRecNet_base_config,
    "PlaneRecNet_101_config": PlaneRecNet_101_config,
    "PlaneRecNet_50_config": PlaneRecNet_50_config,
    "PlaneRecNet_tiny_config": PlaneRecNet_tiny_config,
    "SOLOv2_R101_DCN_config": SOLOv2_R101_DCN_config,
}


_DATASETS = {
    "dataset_base": dataset_base,
    "scannet_dataset": scannet_dataset,
    "nyu_eval": nyu_eval,
    "S2D3DS_dataset": S2D3DS_dataset,
}


def get_cfg(config_name: str) -> PlaneRecNetConfig:
    """Look a preset up by name (``"PlaneRecNet_50_config"``)."""
    if config_name not in _CONFIGS:
        raise KeyError(
            f"Unknown config '{config_name}'. Available: {sorted(_CONFIGS)}")
    return _CONFIGS[config_name]


set_cfg = get_cfg


def set_dataset(cfg: PlaneRecNetConfig, dataset_name: str
                ) -> PlaneRecNetConfig:
    """``cfg`` with the dataset preset ``dataset_name``."""
    if dataset_name not in _DATASETS:
        raise KeyError(
            f"Unknown dataset '{dataset_name}'. Available: {sorted(_DATASETS)}")
    return cfg.copy(dict(dataset=_DATASETS[dataset_name]))


def apply_overrides(cfg, overrides: dict):
    """Apply a plain, possibly nested dict of overrides to a frozen config
    tree: ``{"max_iter": 10, "solov2": {"top_k": 20}}`` (the CLIs'
    ``--cfg_overrides``). Unknown keys raise; JSON lists become tuples."""
    upd = {}
    for key, val in overrides.items():
        if not hasattr(cfg, key):
            raise KeyError(f"{type(cfg).__name__} has no field '{key}'")
        cur = getattr(cfg, key)
        if isinstance(val, dict) and dataclasses.is_dataclass(cur):
            upd[key] = apply_overrides(cur, val)
        else:
            upd[key] = val
    return cfg.copy(upd)
