#!/bin/bash
# Full smoke run of this tree, then the DCN kernels of the parent tree
# (unpacked in _archive/parent) and of this one in turns on the same card,
# then the cross-tree checkpoints. Logs go to OUT_DIR.
#     bash _archive/scatter_det/measure.sh OUT_DIR
out=$(realpath -m "${1:?usage: measure.sh OUT_DIR}")
mkdir -p "$out"
python3 chip_smoke.py > "$out/smoke.log" 2>&1; echo "smoke exit $?"
tail -3 "$out/smoke.log" | cut -c1-300
for t in parent here here parent; do
  if [ $t = parent ]; then d=_archive/parent; else d=.; fi
  (cd $d && python3 chip_smoke.py --dcn) > "$out/dcn_$t.$RANDOM.log" 2>&1
  echo "dcn $t exit $?"
done
grep -h "^\[dcn\]\|^\[scatter\] [0-9]" "$out"/dcn_*.log | cut -c1-400
python3 _archive/scatter_det/cross_tree.py _archive/parent; echo "cross exit $?"
