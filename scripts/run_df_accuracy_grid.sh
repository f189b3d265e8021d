#!/usr/bin/env bash
# Full double-float accuracy grid: all four reference stability scenarios
# at the reference's 20-row k grid, run through the df path
# (algorithms/df.py) on the default backend, one process at a time. The
# output names keep the historical "_tpu_df" suffix the results pin.
set -euo pipefail
cd "$(dirname "$0")/.."
OUT=${1:-results}
for fn in inv exp; do
  for sc in well ill; do
    echo "=== $fn / $sc-conditioned (df) ==="
    PYTHONPATH=$PWD:${PYTHONPATH:-} python -m two_pass_lanczos_tpu.experiments.stability \
      --function "$fn" --scenario "$sc-conditioned" --size 10000 \
      --k-min 10 --k-max 200 --k-step 10 --precision df \
      --output "$OUT/accuracy_${fn}_${sc}-conditioned_tpu_df.csv"
  done
done
echo "df accuracy grid complete"
