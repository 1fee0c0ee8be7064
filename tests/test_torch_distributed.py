"""The port's cluster join (``parallel/distributed.py``) against the JAX
package's (``tests/parallel/test_distributed.py`` and, slow-marked, the
two-process join of ``tests/parallel/test_multihost.py``).

The default cases cover the env-driven argument resolution and the global
mesh's layout policy in one process. The two-process cases spawn two OS
processes that join over gloo through ``initialize_cluster`` into one
cluster of 2 x 4 CPU entries; ``global_mesh(model_parallel=2)`` spans both,
and an all-reduce of one row block per process must see both blocks.
Readiness is handshaked through marker files (ready -> joined -> exit), each
phase with its own budget, failing at once when a process dies.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import pytest
import torch

from kobato_eyes_tpu.parallel import distributed as jdistributed
from kobato_eyes_tpu_torch.parallel import distributed

REPO = Path(__file__).resolve().parents[1]
PHASE_BUDGET_S = 120.0
CPU8 = ["cpu"] * 8


def test_initialize_cluster_env_fallbacks(monkeypatch):
    calls, jcalls = [], []
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: jcalls.append(kw))
    monkeypatch.setenv("KET_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("KET_NUM_PROCESSES", "4")
    monkeypatch.setenv("KET_PROCESS_ID", "2")
    distributed.initialize_cluster()
    jdistributed.initialize_cluster()
    assert calls == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 2}]
    assert jcalls == [{"coordinator_address": "10.0.0.1:1234", "num_processes": 4, "process_id": 2}]


def test_initialize_cluster_explicit_args_win(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setenv("KET_COORDINATOR", "ignored:1")
    distributed.initialize_cluster("host:9999", num_processes=2, process_id=1, backend="nccl")
    assert calls == [{"backend": "nccl", "init_method": "tcp://host:9999", "world_size": 2, "rank": 1}]


def test_initialize_cluster_needs_all_three(monkeypatch):
    for name in ("KET_COORDINATOR", "KET_NUM_PROCESSES", "KET_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize_cluster(num_processes=2, process_id=0)


def test_global_mesh_shape():
    mesh = distributed.global_mesh(model_parallel=2, local_devices=CPU8)
    jmesh = jdistributed.global_mesh(model_parallel=2)
    assert mesh.shape == jmesh.shape
    assert mesh.shape["model"] == 2
    assert mesh.shape["data"] == len(CPU8) // 2
    assert (mesh.process_ids == 0).all() and mesh.local_devices.shape == (4, 2)


def test_global_mesh_warns_when_model_crosses_hosts(caplog):
    """model_parallel beyond the local device count = tensor collectives
    across hosts; the layout policy warns (and one process cannot build that
    mesh — its data axis would be 0)."""
    with caplog.at_level("WARNING", logger="kobato_eyes_tpu_torch.parallel.distributed"):
        with pytest.raises(ValueError):
            distributed.global_mesh(model_parallel=2 * len(CPU8), local_devices=CPU8)
    assert any("will cross DCN" in r.message for r in caplog.records)


_WORKER = """
import sys
from pathlib import Path

import torch

pid, nproc, port, markers = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])

from kobato_eyes_tpu_torch.parallel.distributed import global_mesh, initialize_cluster

(markers / f"ready_{pid}").touch()  # imports done, about to rendezvous

INIT_CALL

assert torch.distributed.get_world_size() == nproc, torch.distributed.get_world_size()
(markers / f"joined_{pid}").touch()  # cluster rendezvous complete

mesh = global_mesh(model_parallel=2, local_devices=["cpu"] * 4)
assert dict(mesh.shape) == {"data": nproc * 4 // 2, "model": 2}, mesh.shape
assert sorted(set(mesh.process_ids.flat)) == list(range(nproc))
assert (mesh.process_ids[:2] == 0).all() and (mesh.process_ids[2:] == 1).all()

# one row block per process: the sum is right only if the reduction
# between processes moved data
local = torch.full((4, 8), float(pid + 1))
total = local.sum()
torch.distributed.all_reduce(total)
expected = 4 * 8 * sum(range(1, nproc + 1))
assert float(total) == expected, (float(total), expected)
torch.distributed.destroy_process_group()
print(f"proc{pid} OK total={float(total)}", flush=True)
"""

_EXPLICIT_INIT = 'initialize_cluster(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)'


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _drain(procs) -> list[str]:
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out or "")
    return outs


def _wait_phase(procs, markers: list[Path], phase: str) -> None:
    """Block until every marker exists; fail FAST if any process exits
    non-zero, fail at PHASE_BUDGET_S if the phase hangs."""
    deadline = time.monotonic() + PHASE_BUDGET_S
    while time.monotonic() < deadline:
        for k, p in enumerate(procs):
            rc = p.poll()
            if rc is not None and rc != 0:
                outs = _drain(procs)
                raise AssertionError(f"proc{k} died (rc={rc}) during phase {phase!r}:\n" + "\n---\n".join(outs))
        if all(m.exists() for m in markers):
            return
        time.sleep(0.2)
    outs = _drain(procs)
    raise AssertionError(
        f"phase {phase!r} not reached within {PHASE_BUDGET_S:.0f}s; "
        f"markers present: {[m.name for m in markers if m.exists()]}\n" + "\n---\n".join(outs)
    )


def _run_pair(tmp_path: Path, init_call: str, extra_env) -> list[str]:
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.replace("INIT_CALL", init_call))
    markers = tmp_path / "markers"
    markers.mkdir()
    port = _free_port()
    procs = []
    for k in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", **extra_env(k, port)}
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(k), "2", str(port), str(markers)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    try:
        _wait_phase(procs, [markers / f"ready_{k}" for k in range(2)], "ready")
        _wait_phase(procs, [markers / f"joined_{k}" for k in range(2)], "joined")
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=PHASE_BUDGET_S)
            outs.append(out)
        for k, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"proc{k} failed:\n{out}"
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.mark.slow
def test_two_process_cluster_global_reduction(tmp_path):
    outs = _run_pair(tmp_path, _EXPLICIT_INIT, lambda k, port: {})
    for k, out in enumerate(outs):
        assert f"proc{k} OK" in out, out


@pytest.mark.slow
def test_env_driven_initialization(tmp_path):
    """KET_COORDINATOR / KET_NUM_PROCESSES / KET_PROCESS_ID env fallbacks."""
    outs = _run_pair(
        tmp_path,
        "initialize_cluster()",
        lambda k, port: {"KET_COORDINATOR": f"127.0.0.1:{port}", "KET_NUM_PROCESSES": "2", "KET_PROCESS_ID": str(k)},
    )
    for k, out in enumerate(outs):
        assert f"proc{k} OK" in out, out
