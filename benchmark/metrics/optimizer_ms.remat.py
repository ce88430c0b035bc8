"""``optimizer_ms.train``'s reading, in the training cells whose
rate is ``train_img_per_s.remat`` (the backbone recomputed in the
backward)."""

from pathlib import Path

from benchmark.spec import reader

read = reader(Path(__file__).with_name("optimizer_ms.train.py"))
