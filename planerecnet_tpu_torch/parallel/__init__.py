"""Data-parallel training (counterpart of ``planerecnet_tpu/parallel/``)."""
