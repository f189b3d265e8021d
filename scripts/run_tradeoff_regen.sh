#!/usr/bin/env bash
# Tradeoff sweeps on the default backend with per-(variant,k) process
# isolation (single-configuration peaks) and median-of-5 timing. Workers
# run one at a time, so one process holds the card; they share the
# checkout's persistent compile cache (utils/compile_cache.py).
set -euo pipefail
cd "$(dirname "$0")/.."
OUT=${1:-results}
for arcs in 5000 50000 500000; do
  case $arcs in
    5000) name=5k;; 50000) name=50k;; *) name=500k;;
  esac
  echo "=== tradeoff arcs=$arcs (isolated, repeats=5) ==="
  PYTHONPATH=$PWD:${PYTHONPATH:-} python -m two_pass_lanczos_tpu.experiments.tradeoff \
    --arcs "$arcs" --rho 3 --k-start 50 --k-end 1000 --k-step 50 \
    --isolate --repeats 5 \
    --output "$OUT/tradeoff_arcs${name}_rho3.csv"
done
echo "tradeoff regeneration complete"
