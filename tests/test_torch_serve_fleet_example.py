"""``examples/serve_fleet_gpu.py --autoscale`` on the CPU: the port's
fleet example hands capacity to the autoscaler, whose 5 ms queue-wait
target makes the batch a breach, so it buys a joiner replica; every
request still matches the example's local reference."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_example_autoscale_buys_a_replica():
    """``examples/serve_fleet_gpu.py --autoscale --device cpu``: the
    batch breaches the 5 ms target and the autoscaler buys a joiner;
    every request still matches the local reference."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "serve_fleet_gpu.py"),
         "--device", "cpu", "--replicas", "1", "--requests", "6",
         "--autoscale"], capture_output=True, text=True, env=env,
        cwd=str(REPO), timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "autoscaler bought 1 replica(s)" in out.stdout, out.stdout
    assert "6/6 requests completed" in out.stdout
    assert "exact match vs uninterrupted reference run OK" in out.stdout
