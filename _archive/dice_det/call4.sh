#!/bin/bash
# check.py (every case, timed), then the probe of variants2.json:
#   bash _archive/dice_det/call4.sh OUT_DIR
set -e
out=$1
mkdir -p "$out"
python3 _archive/dice_det/check.py > "$out/check.log" 2>&1 || { tail -50 "$out/check.log"; exit 1; }
grep -E "^spills|^\[dice\] (fwd|bwd)|share of" "$out/check.log" | cut -c1-400 | sed -n '1,40p'
python3 _archive/dice_det/probe.py _archive/dice_det/variants2.json "$out" 2>&1 | grep -E "probe"
