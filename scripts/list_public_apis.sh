#!/usr/bin/env bash
set -euo pipefail

# List the public C API surface (one symbol per line) from the shim
# header — the count is the parity number checked against the reference
# (ref: scripts/list_public_apis.sh; 79 exported HYPREDRV_* functions
# in the reference, 89 here including this framework's additions).
#
# Usage: scripts/list_public_apis.sh [header]

header="${1:-native/include/HYPREDRV_tpu.h}"
grep -oE 'HYPREDRV_[A-Za-z0-9_]+\(' "$header" \
  | sed 's/($//; s/(//' | sort -u
