"""Multi-process (jax.distributed) smoke of the row-partitioned solver: two
OS processes x 4 virtual CPU devices = one 8-device global mesh spanning
process boundaries. This is the strategy SURVEY §4 prescribes for the
capability the reference cannot test (it is single-threaded).

The subprocesses run scripts/multihost_smoke.py; the oracle ||b|| comes from
an in-process computation on the identical seeded instance.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_solve():
    # oracle: same seeded instance as the smoke script
    rng = np.random.default_rng(11)
    m, p = 4000, 300
    rng.integers(0, p, m)
    rng.integers(0, p - 1, m)
    rng.uniform(1.0, 3.0, m)
    b = rng.standard_normal(m + p).astype(np.float32)
    bnorm = float(np.linalg.norm(b.astype(np.float64)))

    port = _free_port()
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "scripts" / "multihost_smoke.py"),
             "--num-processes", "2", "--process-id", str(pid),
             "--coordinator", f"localhost:{port}",
             "--expect-bnorm", repr(bnorm)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
            env={**os.environ,
                 "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}"}))
    outs = []
    for pr in procs:
        try:
            out, err = pr.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for p2 in procs:
                p2.kill()
            pytest.fail("multihost smoke timed out")
        outs.append((pr.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-2000:]}"
    assert any("MULTIHOST_OK" in out for _, out, _ in outs)


def test_scaling_artifact_published():
    """The committed virtual-mesh scaling artifact
    (results/scaling_virtual.json) carries the documented schema: the row
    partition at nproc {1,2,4}, every record marked meaningful:false (a CPU
    virtual mesh, not a device measurement), plus the command line to
    re-run it."""
    import json

    art = Path(__file__).resolve().parents[1] / "results" / "scaling_virtual.json"
    assert art.exists(), "results/scaling_virtual.json not committed"
    doc = json.loads(art.read_text())
    assert doc["host"]["backend"] == "cpu"
    metrics = {r["metric"]: r for r in doc["records"] if "metric" in r}
    for nproc in (1, 2, 4):
        r = metrics[f"scaling_generic_nproc{nproc}"]
        assert r["seconds_per_step"] > 0 and r["nnz_per_s"] > 0
        assert r["meaningful"] is False
    assert any("note" in r for r in doc["records"])


def test_scaling_bench_two_process_schema():
    """`scripts/scaling_bench.py` runs 1- and 2-process sweeps on the
    virtual mesh and emits the documented JSON schema for the row
    partition. Virtual numbers are correctness-grade only."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parent.parent / "scripts" / "scaling_bench.py"
    proc = subprocess.run(
        [sys.executable, str(script), "--processes", "1", "2",
         "--arcs", "20000", "--k", "8", "--reps", "1", "--port", "8603"],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    records = [json.loads(l) for l in proc.stdout.splitlines()
               if l.startswith("{")]
    metrics = {r["metric"]: r for r in records if "metric" in r}
    for nproc in (1, 2):
        r = metrics[f"scaling_generic_nproc{nproc}"]
        assert r["seconds_per_step"] > 0
        assert r["nnz_per_s"] > 0
        assert r["ndev"] == 4 * nproc
        assert r["meaningful"] is False  # virtual mesh
    assert metrics["scaling_generic_nproc1"]["efficiency_vs_1proc"] == 1.0
