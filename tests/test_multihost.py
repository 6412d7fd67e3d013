"""Multi-process ("multi-host") execution test — SURVEY.md §7 step 7.

Spawns 2 worker processes × 4 virtual CPU devices each over a localhost
`jax.distributed` coordinator (gloo collectives — the CPU stand-in for the
network between hosts) and checks that both solver tiers run sharded over
the resulting 8-device global mesh with every process observing identical
fleet-wide psum stats.
See tests/multihost_worker.py for what each worker asserts internally.
"""
import os
import re
import socket
import subprocess
import sys

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_pod():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONUNBUFFERED"] = "1"
    workers = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=os.path.dirname(os.path.dirname(_WORKER)))
        for i in range(2)
    ]
    outs = []
    try:
        for w in workers:
            out, _ = w.communicate(timeout=1500)
            outs.append(out)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
    for i, (w, out) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"worker {i} failed (rc={w.returncode}):\n{out}"
        assert f"WORKER {i} OK" in out, out

    # fleet-wide psum results must be identical on every process
    for tag in ("XLA_STATS", "LANE_STATS", "FLEET_STATS", "KL_STATS"):
        vals = [re.search(rf"{tag} (.*)", o) for o in outs]
        assert all(v is not None for v in vals), outs
        assert vals[0].group(1) == vals[1].group(1), (
            tag, vals[0].group(1), vals[1].group(1))
