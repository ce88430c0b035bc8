"""Build the dice/lava kernels and hold them against their plain versions.

    python3 _archive/dice_det/check.py

Runs from the repository root on one card: the build (ptxas's spill
stores of every dice/lava kernel, printed, not gated), then
``chip_smoke.phase_dice``: every ``DICE_CASES`` entry and the two training
shapes, the deterministic variants twice and at another grid, then timed.
With ``--timing`` the training shapes only (``chip_smoke.py --dice``
without its spill gate).
"""
import os
import sys

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from planerecnet_tpu_torch.ops import cuda_build  # noqa: E402

cs.phase_device()
info = cuda_build.build(fresh=("dice_lava",))
log = info["dice_lava"]["log"]
print("spills", sorted(cs.dice_spills(log).items()), flush=True)
for line in log.splitlines():
    if "registers" in line or "Function properties" in line:
        print(line)
out = cs.phase_dice(cases=() if "--timing" in sys.argv else cs.DICE_CASES)
print("dice", out, flush=True)
