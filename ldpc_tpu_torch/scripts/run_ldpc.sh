#!/usr/bin/env bash
# Convenience launcher of the port's CLI (analogue of the reference's
# run_ldpc.bat; counterpart of scripts/run_ldpc.sh), on the card:
#   ./ldpc_tpu_torch/scripts/run_ldpc.sh [matrix] [encoding] [ru_gap]
# Defaults to the built-in BCH(7,4) with standard encoding, BER+FER on.
set -euo pipefail
cd "$(dirname "$0")/../.."

MATRIX="${1:-builtin:BCH_7_4_1_strip.alist.txt}"
ENCODING="${2:-standard}"
RU_GAP="${3:-}"

ARGS=(--matrix "$MATRIX" --encoding-method "$ENCODING"
      --blocks 100 --iterations 5 --ber --fer
      --initial-snr 0 --end-snr 5 --step-snr 0.5)
if [[ -n "$RU_GAP" ]]; then
  ARGS+=(--ru-gap "$RU_GAP")
fi

exec python -m ldpc_tpu_torch.cli "${ARGS[@]}"
