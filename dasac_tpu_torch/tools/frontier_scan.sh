#!/bin/sh
# Training-throughput frontier scan (remat, batch, groups) of the port's
# bench on one GPU (counterpart of tools/frontier_scan.sh): the same five
# points, one `python -m dasac_tpu_torch.tools.bench --mode step` each;
# results append as JSON lines to $OUT, a point that fails as a line with
# its error.  The flagship point (remat none, batch 8, groups 2) is the
# bench's default run.  Run from the root of a checkout.
OUT=${OUT:-${TMPDIR:-/tmp}/frontier_scan.jsonl}
ERR=${ERR:-${TMPDIR:-/tmp}/frontier_err.log}
: > "$OUT"
for cfg in "none 12 3" "block 12 3" "block 16 4" "convs 12 3" "convs 16 4"; do
  set -- $cfg
  echo "=== remat=$1 batch=$2 groups=$3 ===" >&2
  if timeout 2400 python -m dasac_tpu_torch.tools.bench --mode step \
       --remat "$1" --batch "$2" --groups "$3" --iters 10 >> "$OUT" 2>"$ERR"
  then :; else
    echo "{\"remat\": \"$1\", \"batch\": $2, \"groups\": $3, \"error\": \"$(tail -1 "$ERR" | tr '\"' "'" | cut -c1-200)\"}" >> "$OUT"
  fi
done
echo "frontier scan done" >&2
