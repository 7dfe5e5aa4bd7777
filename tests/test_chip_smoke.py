"""chip_smoke.py must never report ok without a GPU."""

import os
import subprocess
import sys

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_cpu_only_host():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_CHECKOUT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr
