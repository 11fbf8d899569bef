#!/bin/bash
# Time whole chip_smoke.py runs of several checkouts in turns, on one card:
#
#     bash chip_smoke_turns.sh OUT_DIR LABEL:DIR [LABEL:DIR ...]
#
# Each DIR is a checkout (this one is "."; another, a `git archive` unpacked
# under the git-ignored build/). Its chip_smoke.py runs from DIR, its output
# goes to OUT_DIR/turn_LABEL.log and .err, and one line per run (label,
# directory, exit code, wall seconds) to OUT_DIR/turns.txt, after the card's
# name and power limit.
cd "$(dirname "$0")"
out=$(realpath -m "$1")
shift
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$out/turns.txt"
for spec in "$@"; do
  label=${spec%%:*}; dir=${spec#*:}
  t0=$(date +%s.%N)
  (cd "$dir" && python3 chip_smoke.py > "$out/turn_$label.log" 2> "$out/turn_$label.err")
  rc=$?
  t1=$(date +%s.%N)
  echo "$label dir=$dir rc=$rc seconds=$(python3 -c "print(round($t1 - $t0, 1))")" \
    | tee -a "$out/turns.txt"
done
