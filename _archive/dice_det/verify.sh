#!/bin/bash
# The SASS of this tree's dice/lava kernels against _archive/parent's, then
# check.py (every case, the variants twice and at 114 SMs, timed):
#   bash _archive/dice_det/verify.sh OUT_DIR
out=$1
mkdir -p "$out"
python3 _archive/dice_det/sass_same.py _archive/parent 2>&1 | grep "^\[sass\]"
python3 _archive/dice_det/check.py > "$out/check.log" 2>&1 || { tail -40 "$out/check.log"; exit 1; }
grep -E "^spills|^\[dice\] (fwd|bwd)" "$out/check.log" | cut -c1-250
grep -o "training shape.\{0,60\}\|\"dk\": [0-9.]*, \"dm\": [0-9.]*, \"a_det[^}]*}" "$out/check.log" | paste - - | sed 's/"a_det.*"dk_det"/dk_det/' | tail -2
