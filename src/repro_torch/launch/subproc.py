"""Run a module in a subprocess over a fake world of N ranks (the port of
``repro.launch.subproc``).

The reference re-executes an interpreter because jax pins its device count
at first init.  The port's meshes live in a fake process group that a
process builds and tears down itself (``launch.mesh.fake_world``), so one
process could run any cell; the dry-run sweep still runs one cell per
process, so that a cell that hangs or exhausts memory costs only itself.
``n_devices`` is kept for the reference's signature and is unused: each
dry-run cell builds the fake world its own mesh needs.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def run_with_devices(n_devices: int, module: str, *args: str,
                     timeout: int = 900, expect_json: bool = True):
    """``python -m module *args`` with ``src/`` on the path (``n_devices``
    unused, see the module docstring); raises ``RuntimeError`` on a nonzero
    exit code.  Returns the last JSON line of its stdout (``expect_json``)
    or all of it."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=root)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{module} failed (rc={proc.returncode}):\n{proc.stdout[-4000:]}\n"
            f"{proc.stderr[-4000:]}")
    if not expect_json:
        return proc.stdout
    # last JSON line on stdout is the payload
    for line in reversed(proc.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{") or line.startswith("["):
            return json.loads(line)
    raise RuntimeError(f"{module} produced no JSON payload:\n{proc.stdout[-2000:]}")
