"""The data pipeline: COCO-format datasets, augmentation and the loader
(counterpart of ``planerecnet_tpu/data``)."""

from planerecnet_tpu_torch.data.coco import (  # noqa: F401
    COCO, mask_to_rle, polygons_to_mask, rle_to_mask)
from planerecnet_tpu_torch.data.datasets import (  # noqa: F401
    DATASET_CLASSES,
    BatchIterator,
    NYUDataset,
    PlaneAnnoDataset,
    PrefetchIterator,
    S2D3DSDataset,
    ScanNetDataset,
    build_dataset,
    collate_batch,
    enforce_size,
    pad_instances,
)
from planerecnet_tpu_torch.data.augmentations import (  # noqa: F401
    BaseTransform,
    Pad,
    ResizeAndPad,
    SSDAugmentation,
)
