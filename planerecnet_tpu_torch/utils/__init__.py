from planerecnet_tpu_torch.utils.utils import (  # noqa: F401
    MovingAverage,
    ProgressBar,
    SavePath,
    init_console,
)
