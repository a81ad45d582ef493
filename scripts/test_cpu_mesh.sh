#!/usr/bin/env bash
# Run the test suite on the CPU with a simulated 8-device mesh (no
# accelerator needed); the platform env is set before Python starts.
set -euo pipefail
cd "$(dirname "$0")/.."
exec env JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=8" \
    python -m pytest tests/ -q "$@"
