#!/bin/sh
# Runs one cell as its bounds are measured: a traced run, two sets of runs on
# the same seeds, then the other traced runs; every result line (with its
# set, seed and exit code) goes to $OUT/sets_<cell>.jsonl, each run's
# standard error beside it (OUT defaults to gpubench_out).
#   sh gpubench/sets.sh <cell> "<set seeds>" "<traced seeds>"
cell=$1 seeds=$2 traced=$3
OUT=${OUT:-gpubench_out}
out=$OUT/sets_$cell.jsonl
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() {
    set_=$1 seed=$2 trace=$3
    python3 gpubench/run.py --workload "$cell" --seed "$seed" --seconds 51 --trace "$trace" \
        > "$OUT/run.out" 2> "$OUT/err_${cell}_${set_}_${seed}.txt"
    rc=$?
    line=$(tail -n 1 "$OUT/run.out")
    echo "{\"set\": \"$set_\", \"seed\": $seed, \"trace\": $trace, \"rc\": $rc, \"line\": ${line:-null}}" >> "$out"
    echo "$set_ $seed trace=$trace rc=$rc $(grep -E '^(window|correct|compared)' "$OUT/err_${cell}_${set_}_${seed}.txt" | tr '\n' ' ')"
}
first=${traced%% *}
rest=${traced#"$first"}
one T "$first" 1
for s in $seeds; do one A "$s" 0; done
for s in $seeds; do one B "$s" 0; done
for t in $rest; do one T "$t" 1; done
