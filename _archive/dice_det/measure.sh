#!/bin/bash
# The deterministic dice/lava variants against the parent tree on one card:
#   bash _archive/dice_det/measure.sh OUT_DIR
# (the parent unpacked by `git archive` into _archive/parent). The SASS of
# both trees' kernels, then the training-shape timings of `--dice` from the
# parent (its own chip_smoke.py) and from here, in turns parent, here,
# here, parent; every log into OUT_DIR.
set -e
out=$1
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
python3 _archive/dice_det/sass_same.py _archive/parent 2>&1 | tee "$out/sass.log"
python3 _archive/dice_det/check.py > "$out/check.log" 2>&1
grep -E "^\[dice\]|^spills" "$out/check.log"
run_parent() { (cd _archive/parent && python3 chip_smoke.py --dice) > "$out/$1.log" 2>&1; }
run_here() { python3 _archive/dice_det/check.py --timing > "$out/$1.log" 2>&1; }
run_parent parent1; run_here here1; run_here here2; run_parent parent2
grep -H -E "^\[dice\] (fwd|bwd)" "$out"/parent1.log "$out"/here1.log "$out"/here2.log "$out"/parent2.log
