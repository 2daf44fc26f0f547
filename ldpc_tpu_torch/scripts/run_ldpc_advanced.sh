#!/usr/bin/env bash
# Advanced preset launcher of the port's CLI (analogue of the reference's
# run_ldpc_advanced.bat; counterpart of scripts/run_ldpc_advanced.sh), on
# the card: larger block count, CCSDS n=32 matrix, JSON/CSV export and
# dashboard plots.
set -euo pipefail
cd "$(dirname "$0")/../.."

MATRIX="${1:-builtin:CCSDS_ldpc_n32_k16.alist.txt}"
OUT="${2:-results}"

exec python -m ldpc_tpu_torch.cli \
  --matrix "$MATRIX" \
  --blocks 1000 --iterations 10 --ber --fer --normalized-llr \
  --initial-snr 0 --end-snr 5 --step-snr 0.5 \
  --output-json "$OUT.json" --output-csv "$OUT.csv" \
  --plot-save plots
