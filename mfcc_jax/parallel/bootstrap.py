"""Bootstrap for virtual multi-device CPU meshes in a child process.

Role parity: the reference's platform layer materializes the target hardware
for its gateware (mfcc/board/sdmulator.py:19-89); here the
"platform" is the JAX device mesh, and this module materializes an n-device
mesh even in environments where that is otherwise impossible.

The problem it solves: once jax has initialized its backends, the device set
is fixed -- setting ``JAX_PLATFORMS`` / ``XLA_FLAGS`` afterwards has no
effect, and an in-process n-device CPU mesh cannot be created (for example
in a process that already holds a GPU).  The fix is to re-exec the target in
a subprocess whose environment (a) puts only the repo on ``PYTHONPATH`` and
(b) forces an n-device CPU host platform before jax initializes.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cpu_mesh_env(n_devices: int) -> dict:
    """Environment for a child process that will see an ``n_devices``-device
    CPU platform: PYTHONPATH is replaced by the repo root, the platform is
    forced to cpu, and the host-device-count flag is (re)set."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT
    env["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append(f"--xla_force_host_platform_device_count={n_devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    return env


def run_in_cpu_mesh(args: list[str], n_devices: int, *,
                    timeout: float = 1800.0,
                    check: bool = True) -> subprocess.CompletedProcess:
    """Run ``python <args...>`` in a subprocess that sees an n-device CPU
    mesh.  Streams the child's output to this process's stdout/stderr and
    raises on nonzero exit when ``check``."""
    proc = subprocess.run(
        [sys.executable, *args], env=cpu_mesh_env(n_devices), cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=timeout)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    if check and proc.returncode != 0:
        raise RuntimeError(
            f"CPU-mesh subprocess failed (rc={proc.returncode}): "
            f"python {' '.join(args)}")
    return proc
