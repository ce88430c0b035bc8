"""A measurement on the card behind PERF.md (its exploratory runs on the
spatial axis): the split over NCCL, one card a rank, on a host with 4.

    python3 _archive/spatial/nccl.py

1. ``chip_smoke.py`` phases 15-16 with NCCL: 2 ranks on 2 cards, then 4
   ranks on 4, each against one unsplit rank (its checks as on one card).
2. ``tools/profile_spatial.py`` with PyTorch's defaults (TF32 on): one
   card's forward and estimate, then the real split over 2 and over 4
   cards, one 1x640x640 and one 1x480x640 frame: the latency of one
   frame split over cards.
"""
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

card = cs.phase_device()
cs.phase_build()
for ranks in (2, 4):
    cs.SP_RANKS = ranks
    work = tempfile.mkdtemp(prefix="prn_nccl_")
    print(cs.phase_spatial(card, work, backend="nccl"), flush=True)
for h in (640, 480):
    tool = ["-m", "planerecnet_tpu_torch.tools.profile_spatial",
            "--height", str(h), "--width", "640"]
    subprocess.run([sys.executable, *tool, "--shards", "2"], check=True)
    for ranks in (2, 4):
        subprocess.run([sys.executable, "-m",
                        "planerecnet_tpu_torch.tools.run_multihost",
                        "--nproc", str(ranks), "--timeout", "300",
                        "--module", " ".join(tool[1:2] + ["--multihost"]),
                        "--", *tool[2:]], check=True)
print("done", flush=True)
