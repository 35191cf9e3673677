"""Multi-host execution with REAL process boundaries.

Two CPU subprocesses under ``jax.distributed.initialize`` (localhost
coordinator), one global 2-device mesh, end-to-end ``fit()`` — the only
pod-readiness evidence obtainable without pod hardware (SURVEY.md §2.3
multi-host row; the 8-virtual-device mesh used elsewhere in the suite is
single-process and never crosses a transport). Asserts the two processes
agree on metrics and that ONLY process 0 writes the host observability
surface (stdout, CSV, metrics.jsonl)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_RUNNER = os.path.join(os.path.dirname(__file__), "multihost_runner.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_pair(mode: str, out_dir: str, devices_per_proc: int = 1):
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=(f"--xla_force_host_platform_device_count="
                   f"{devices_per_proc}"),
        PYTHONPATH=os.pathsep.join(
            [repo_root] + os.environ.get("PYTHONPATH", "").split(os.pathsep)
        ).rstrip(os.pathsep),
    )
    port = str(_free_port())
    # subprocess output goes to FILES, not pipes: waiting on proc 0 while
    # proc 1 fills a 64 KB stdout pipe deadlocks the pair (proc 1 blocks
    # on write, never reaches the distributed shutdown barrier, proc 0
    # times out at it — observed with chatty checkpoint logging)
    logs = [os.path.join(out_dir + f".{mode}.proc{i}.log") for i in (0, 1)]
    os.makedirs(os.path.dirname(logs[0]), exist_ok=True)
    files = [open(p, "w") for p in logs]
    procs = [
        subprocess.Popen(
            # -u: a task killed by the distributed runtime's fatal handler
            # (e.g. its peer died) loses block-buffered stdout — unbuffered
            # output is the only way to see the original traceback
            [sys.executable, "-u", _RUNNER, str(i), port, out_dir, mode],
            stdout=files[i], stderr=subprocess.STDOUT, env=env, text=True)
        for i in (0, 1)
    ]
    return procs, files, logs


def _spawn_pair(mode: str, out_dir: str, devices_per_proc: int = 1):
    procs, files, logs = _launch_pair(mode, out_dir, devices_per_proc)
    try:
        for p in procs:
            p.wait(timeout=600)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()  # exact PIDs we spawned, never by pattern
        raise
    finally:
        for f in files:
            f.close()
    outs = [open(p).read() for p in logs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
    return outs


def _result(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert lines, f"no RESULT line in:\n{out}"
    return json.loads(lines[0][len("RESULT "):])


@pytest.mark.parametrize("mode", ["host", "device"])
def test_two_process_fit(mode, tmp_path):
    out_dir = str(tmp_path / f"run_{mode}")
    out0, out1 = _spawn_pair(mode, out_dir)
    r0, r1 = _result(out0), _result(out1)

    # both processes computed the SAME replicated metrics (the collectives
    # actually crossed the process boundary and agreed)
    assert r0["epochs_run"] == r1["epochs_run"] == 2
    for k in ("val_hr", "val_ndcg", "test_ndcg"):
        assert np.isfinite(r0[k])
        np.testing.assert_allclose(r0[k], r1[k], rtol=1e-6, err_msg=k)
    assert r0["val_hr"] > 0.0  # the tiny model learned something

    # only process 0 owns stdout: epoch lines appear in proc 0's output
    # and NOWHERE in proc 1's
    assert any("Epoch 001" in ln for ln in out0.splitlines())
    assert not any("Epoch" in ln and "Loss" in ln
                   for ln in out1.splitlines())

    # only process 0 wrote the run artifacts, exactly once: one CSV, one
    # metrics.jsonl with one line per epoch (duplicates would mean the
    # process gate failed and both hosts appended)
    csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
    assert len(csvs) == 1
    csv_lines = open(os.path.join(out_dir, csvs[0])).read().splitlines()
    assert sum(1 for ln in csv_lines if ";train;" in ln) == 2
    mlines = open(os.path.join(out_dir, "metrics.jsonl")).read().splitlines()
    assert len(mlines) == 2

    if mode == "host":
        # checkpointing ran under jax.distributed: best/ retained with the
        # human-browsable sidecar, written once
        side = json.load(open(os.path.join(out_dir, "ckpt", "best",
                                           "metrics.json")))
        assert side["epoch"] in (1, 2) and np.isfinite(side["ndcg"])


def test_two_process_failover_resume(tmp_path):
    """The multi-host FAILURE path (SURVEY.md §5): one process of a
    2-process run is killed mid-training after epoch 1's resume snapshot
    committed; restarting the pair on the same run dir must restore
    ``latest/`` and finish, and the final metrics must match an
    uninterrupted run bit-for-bit (per-epoch seeding, loop.py:879 — the
    reference simply loses the run, src/train.py:117-124). The happy
    path above never crosses a crash; this is the round-5 verdict item."""
    import time

    out_dir = str(tmp_path / "run_failover")
    procs, files, logs = _launch_pair("failover_a", out_dir)
    latest = os.path.join(out_dir, "ckpt", "latest")

    def committed_steps():
        if not os.path.isdir(latest):
            return []
        return [d for d in os.listdir(latest) if d.isdigit()]

    try:
        deadline = time.time() + 300
        while not committed_steps():
            assert time.time() < deadline, (
                "no committed latest/ snapshot before deadline:\n"
                + open(logs[0]).read()[-2000:])
            if all(p.poll() is not None for p in procs):
                raise AssertionError(
                    "pair finished before the kill:\n"
                    + open(logs[0]).read()[-2000:])
            time.sleep(0.05)
        # asymmetric unclean death: kill ONE process (exact PID we
        # spawned); the coordination service takes down the survivor —
        # if it hasn't within 60 s, the pod supervisor's kill stands in
        procs[1].kill()
        try:
            procs[0].wait(timeout=60)
        except subprocess.TimeoutExpired:
            procs[0].kill()
        procs[1].wait(timeout=30)
        for p in procs:
            p.wait(timeout=30)
    finally:
        for f in files:
            f.close()
    assert any(p.returncode != 0 for p in procs), \
        "expected an unclean death, both processes exited 0"
    assert committed_steps(), "kill erased the committed snapshot"

    # restart the pair on the same run dir: resumes from latest/
    out0, out1 = _spawn_pair("failover_b", out_dir)
    rb0, rb1 = _result(out0), _result(out1)
    assert rb0["resumed_from"] >= 1
    assert rb0["epochs_run"] == 3

    # yardstick: the SAME 3-epoch schedule, never interrupted
    outs = _spawn_pair("failover_control", str(tmp_path / "run_control"))
    rc0 = _result(outs[0])
    for k in ("val_hr", "val_ndcg", "test_ndcg"):
        assert np.isfinite(rb0[k])
        np.testing.assert_allclose(rb0[k], rb1[k], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(rb0[k], rc0[k], rtol=1e-6, err_msg=(
            f"{k}: resumed run diverged from the uninterrupted control"))


def test_two_process_two_device_sharded_tables(tmp_path):
    """2 processes x 2 devices = 4 global devices on a (model=2, data=2)
    mesh with row-sharded embedding tables. 'model' is the MAJOR mesh
    axis, so each model-axis group pairs device i of process 0 with
    device i of process 1: every sharded-table lookup's gather+psum (and
    its backward scatter) crosses the process transport — not just the
    replicated-gradient psums the 1-device-per-process modes exercise
    (SURVEY.md §2.3 multi-host row at the sharded-table composition)."""
    out_dir = str(tmp_path / "run_sharded")
    out0, out1 = _spawn_pair("sharded", out_dir, devices_per_proc=2)
    r0, r1 = _result(out0), _result(out1)

    assert r0["epochs_run"] == r1["epochs_run"] == 2
    for k in ("val_hr", "val_ndcg", "test_ndcg"):
        assert np.isfinite(r0[k])
        np.testing.assert_allclose(r0[k], r1[k], rtol=1e-6, err_msg=k)
    assert r0["val_hr"] > 0.0

    # each process holds exactly ONE half-table row window, and the two
    # processes hold DIFFERENT windows — the other half of every lookup
    # could only have come over the transport
    for r in (r0, r1):
        assert len(r["local_row_start"]) == 1
        assert r["local_row_count"] == [r["table_rows_global"] // 2]
    assert r0["local_row_start"] != r1["local_row_start"]
