#!/usr/bin/env bash
# Run the five BASELINE.json workload configs end-to-end on the current
# backend and append each JSON summary line to a markdown file.
# Every CLI already stamps dataset provenance into its JSON line.
#
# Usage: bash scripts/run_configs.sh [outfile]
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT="${1:-configs.md}"
PY=python

run() {
  local name="$1"; shift
  echo "== $name: $*" >&2
  local t0=$SECONDS
  local line rc
  line=$("$PY" -m dropout_hamiltonian_montecarlo_tpu.cli "$@" 2>"/tmp/cfg_err_${name}.log" | tail -1)
  rc=$?   # with pipefail: the python status unless tail itself fails
  local dt=$((SECONDS - t0))
  if [ $rc -ne 0 ] || [ -z "$line" ]; then
    echo "   FAILED (rc=$rc, ${dt}s); stderr tail:" >&2
    tail -5 "/tmp/cfg_err_${name}.log" >&2
    echo "- **$name** (wall ${dt}s): FAILED rc=$rc" >> "$OUT"
  else
    echo "   ok (${dt}s)" >&2
    echo "- **$name** (wall ${dt}s): \`$line\`" >> "$OUT"
  fi
}

{
  echo "# BASELINE.json configs, $(date -u +%Y-%m-%dT%H:%M:%SZ)"
  echo
  "$PY" - <<'EOF'
import jax
print(f"Backend: {jax.default_backend()} ({jax.devices()})")
EOF
  echo
} > "$OUT"

# config 1: 2D MVN target, HMC (CPU-runnable reference scenario)
run config1-mvn-hmc mvn-hmc --dim 2 --chains 4 --samples 1000 --warmup 300

# config 2: Bayesian logistic regression on simulated blobs, 32 chains
run config2-logistic-hmc logistic-hmc --chains 32 --samples 1000 --warmup 300

# config 3: MNIST softmax, full-batch NUTS (Kron metric), 128 chains x 1000
# draws — the lockstep chain-BATCHED kernel (every leaf = one batched
# value+grad for all chains), sampled in chunks of 50 draws; WITHOUT --save
# the chunks stay on device and ESS/R-hat/predictive are computed there in
# one program (pass --save FILE to also spool the draws, identical numbers).
run config3-mnist-nuts mnist-nuts --chains 128 --samples 1000 --warmup 150 \
    --max-depth 6 --stream-chunk 50

# config 3b: the same NUTS pipeline on REAL bundled pixels (sklearn digits)
# — non-synthetic provenance check of metric + sampler
run config3b-digits-nuts mnist-nuts --dataset digits --chains 64 \
    --samples 500 --warmup 150 --max-depth 6

# config 4: MNIST dropout MLP, SGHMC minibatch (dropout IN the potential),
# 16 vmapped chains with jittered starts => ESS/split-R-hat computable
# (reference ran 4 multiprocessing workers, 2.-MNIST.ipynb cell 5)
run config4-mlp-sghmc mnist-mlp-sgmcmc --algorithm sghmc --chains 16 \
    --collect-every 20

# config 4b: same with SGLD.  Step 1e-6, not the SGHMC default 1e-5: SGLD
# has no friction term damping the n-scaled gradient, and 1e-5 diverges the
# chain off the SGD mode (observed: posterior-mean train acc 0.10).
run config4b-mlp-sgld mnist-mlp-sgmcmc --algorithm sgld --step-size 1e-6 \
    --chains 16 --collect-every 20

# config 5: PlantVillage conv-feature classifier, tempered SMC (HMC
# mutation) with the particle axis laid out via NamedSharding
run config5-plantvillage-smc plantvillage-smc --particles 256 --n-data 5000 \
    --shard-particles

# config 4c: 32 chains — vmapped chains are near-free until compute-bound
run config4c-mlp-sghmc-32 mnist-mlp-sgmcmc --algorithm sghmc --chains 32 \
    --collect-every 20

# config 5b: SGHMC mutation (BASELINE config 5's "multi-host SGHMC +
# tempered SMC" wording) — minibatch SGHMC mutates on the tempered
# potential.  SGHMC has no MH accept so the mutation needs enough stochastic
# steps per stage (40 x 1e-3) to actually move particles; too few/small
# steps leave particles prior-like, the incremental-weight ESS then allows
# huge lambda jumps, and the run "finishes" in a handful of stages at
# chance accuracy (observed with 5 x 2e-4).
run config5b-smc-sghmc plantvillage-smc --particles 256 --n-data 5000 \
    --mutation sghmc --batch-size 1024 --step-size 1e-3 --mcmc-steps 40 \
    --shard-particles

# config 6: mean-field ADVI baseline next to configs 3/4 (same JSON schema).
# MLP: near-deterministic q init (--init-log-std -6) — the default 0.05
# weight noise through the 256-wide net swamps the likelihood gradient and
# ADVI collapses to the prior mode (observed: accuracy 0.10).
run config6-mnist-vi-softmax mnist-vi --model softmax
run config6b-mnist-vi-mlp mnist-vi --model mlp --init-log-std -6 \
    --learning-rate 3e-3 --num-steps 4000

echo >> "$OUT"
echo "Wrote $OUT" >&2
