"""The port's multi-process feeding (parallel/distributed.py): two OS
processes rendezvous over gloo on a free localhost port, each feeds its
own channel slice on the CPU, runs it through `sharded_run` on its part
of the job's mesh and checks it against its own serial run
(tests/torch_multihost_worker.py), as tests/test_multihost.py does for
the reference."""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_execution():
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(i), "2", str(port)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("multi-process worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert (f"MULTIHOST_OK proc={i}/2 global_devices=8 local_devices=4 "
                f"channels={4 * i}-{4 * i + 3} device=cpu") in out, (
                    f"worker {i} output:\n{out}")
