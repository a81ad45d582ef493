"""REAL 2-process jax.distributed execution test (VERDICT r4 item 1).

Spawns two OS processes (4 virtual CPU devices each) that form a
jax.distributed process group over localhost, build
parallel.mesh.make_multihost_mesh, and drive the flagship sharded batched
HMC kernel + a data-axis psum + per-process HDF5 shard I/O
(scripts/multiprocess_worker.py).  The single-process 8-device run of the
SAME workload function is the parity reference — the multi-host layer must
change the process topology, not the numbers (the reference's multicore
runs, by contrast, change the draw sequence with the worker count,
cpu/hmc_multicore.py:27-33).

Runs only under the simulated CPU mesh (scripts/test_cpu_mesh.sh); the
parent needs 8 devices for the reference run and the children need their
own CPU backends.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import requires_multidevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multiprocess_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    return env


@requires_multidevice
def test_two_process_distributed_parity(tmp_path):
    import jax

    if jax.process_count() > 1:
        pytest.skip("already inside a distributed context")

    port = _free_port()
    env = _worker_env()
    procs = []
    logs = []
    for pid in range(2):
        log = open(tmp_path / f"worker_{pid}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER,
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2",
             "--process-id", str(pid),
             "--outdir", str(tmp_path)],
            env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT))

    try:
        for p in procs:
            rc = p.wait(timeout=420)
            assert rc == 0, _tail(tmp_path, "workers failed")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()

    # both workers reported a formed 2-process / 8-device group
    for pid in range(2):
        lines = (tmp_path / f"worker_{pid}.log").read_text().splitlines()
        payload = json.loads(
            [ln for ln in lines if ln.startswith("{")][-1])
        assert payload["num_processes"] == 2
        assert payload["global_devices"] == 8
        assert payload["local_devices"] == 4

    result = np.load(tmp_path / "result_p0.npz")

    # data-axis psum across the process boundary == full-batch grad
    assert float(result["dp_value_maxdiff"]) <= 1e-3
    assert float(result["dp_grad_maxdiff"]) <= 1e-5

    # per-process shard files reassembled == the allgathered global draws
    assert float(result["io_maxdiff"]) == 0.0

    # parity vs the single-process 8-device run of the SAME workload
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from multiprocess_worker import run_workload  # noqa: E402

    from dropout_hamiltonian_montecarlo_tpu.parallel.mesh import (
        make_multihost_mesh,
    )

    mesh_c = make_multihost_mesh(num_chain_shards=8)
    mesh_cd = make_multihost_mesh(num_chain_shards=4, num_data_shards=2)
    refdir = tmp_path / "ref"
    refdir.mkdir()
    ref, _ = run_workload(mesh_c, mesh_cd, workdir=str(refdir))

    # parity incl. the FULL multi-host streaming composition (streaming
    # driver + mesh + per-process shard files, stage (d))
    for name in ("positions/weights", "positions/bias", "acceptance",
                 "streamed/weights", "streamed/bias"):
        diff = float(np.abs(result[name] - ref[name]).max())
        assert diff <= 2e-3, f"{name}: 2-process vs 1-process diff {diff}"


def _tail(tmp_path, msg):
    parts = [msg]
    for pid in range(2):
        p = tmp_path / f"worker_{pid}.log"
        if p.exists():
            parts.append(f"--- worker {pid} ---")
            parts.extend(p.read_text().splitlines()[-15:])
    return "\n".join(parts)
