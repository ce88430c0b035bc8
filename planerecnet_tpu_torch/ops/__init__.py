"""The port's ops; the CUDA kernels' wrappers count their launches."""


def kernel_counters():
    """{name: (wrapper, attribute)} of every kernel's launch count: the
    atomic kernels' ``launches``, the deterministic variants'
    ``det_launches`` on the same wrappers, and the im2col's launches on
    bf16 inputs (also counted in its ``launches``)."""
    from planerecnet_tpu_torch.ops import dcn, dcn_scatter, dice_lava
    return {"dcn_im2col": (dcn.deform_im2col, "launches"),
            "dcn_scatter": (dcn_scatter.dcn_input_grad, "launches"),
            "dice_lava_fwd": (dice_lava.dice_lava_fwd, "launches"),
            "dice_lava_bwd": (dice_lava.dice_lava_bwd, "launches"),
            "dcn_scatter_det": (dcn_scatter.dcn_input_grad, "det_launches"),
            "dice_lava_fwd_det": (dice_lava.dice_lava_fwd, "det_launches"),
            "dice_lava_bwd_det": (dice_lava.dice_lava_bwd, "det_launches"),
            "dcn_im2col_bf16": (dcn.deform_im2col, "bf16_launches")}


def launch_counts():
    """{name: launches so far} over ``kernel_counters``."""
    return {k: getattr(fn, a) for k, (fn, a) in kernel_counters().items()}
