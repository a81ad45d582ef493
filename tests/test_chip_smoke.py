"""chip_smoke.py off the card: it refuses to run without a GPU, and its
checks reject the failures they guard against."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_gpu(where, tmp_path):
    """On a CPU backend, and in a directory holding nothing of the repo but
    the script, it exits non-zero and prints no ok line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _grads(chains, scale=1.0):
    rng = np.random.default_rng(0)
    return {"weights": scale * rng.normal(size=(chains, 6, 3)),
            "bias": scale * rng.normal(size=(chains, 3))}


@pytest.mark.parametrize("case,ok", [
    ("exact", True),
    ("grad_perturbed", False),
    ("value_off_by_half_nat", False),
])
def test_check_parity(case, ok):
    ref_v = np.array([-1.0e4, -2.0e4, -3.0e4])
    ref_g = _grads(3)
    v, g = ref_v.copy(), _grads(3)
    if case == "grad_perturbed":
        g["weights"][1] *= 1.01          # 1% relative error in one chain
    elif case == "value_off_by_half_nat":
        v[2] += 0.5
    errs = chip_smoke.parity_errors(v, g, ref_v, ref_g)
    assert (chip_smoke.check_parity(*errs) == []) == ok, errs


GOOD_HMC = {"warmup_step_size_median": 0.2, "acceptance": 0.6,
            "divergent_frac": 0.0, "ess_min": 50.0, "ess_p10": 80.0,
            "ess_median": 120.0, "ess_nonfinite": 0}


@pytest.mark.parametrize("bad", [
    {},
    {"warmup_step_size_median": 1e-4},        # precision collapse
    {"acceptance": 0.1},
    {"divergent_frac": 0.05},
    {"ess_min": float("nan"), "ess_nonfinite": 3},
])
def test_check_hmc(bad):
    failures = chip_smoke.check_hmc({**GOOD_HMC, **bad})
    assert (failures == []) == (not bad), failures


def test_check_finite_and_shard_parity():
    j = json.loads('{"min_ess": 10.0, "max_rhat": NaN}')
    assert chip_smoke.check_finite(j, ("min_ess",)) == []
    assert chip_smoke.check_finite(j, ("min_ess", "max_rhat")) != []
    assert chip_smoke.check_shard_parity(1.0, 0.0) == []
    assert chip_smoke.check_shard_parity(0.9, 0.0) != []
    assert chip_smoke.check_shard_parity(1.0, 0.1) != []


def test_vag_flops_mnist_width():
    # two GEMM passes of 2*N*D*K*C at the MNIST bench shape
    assert chip_smoke.vag_flops(60000, 784, 10, 128) == 4 * 60000 * 784 * 1280
