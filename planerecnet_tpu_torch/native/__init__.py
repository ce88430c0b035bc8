"""Native (C) host code of the port, built at first use with the system C
compiler. Counterpart of ``planerecnet_tpu/native/``; nothing here falls
back to Python."""

from planerecnet_tpu_torch.native.rle_native import (  # noqa: F401
    library,
    rle_decode_counts_native,
    rle_encode_mask_native,
    rle_fill_native,
)
