"""The measurement contract: bench.py prints exactly ONE parseable JSON line
that names the device it ran on, and refuses to time a CPU unless the CPU
was asked for explicitly; dryrun_multichip never initializes the ambient
backend while deciding where to run."""

import json
import os
import subprocess
import sys
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")


def _run_bench(extra_env, timeout=300, args=()):
    env = dict(os.environ)
    env.update(extra_env)
    return subprocess.run([sys.executable, BENCH, *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def _json_line(stdout):
    lines = [l for l in stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 1, f"expected exactly one JSON line, got: {stdout!r}"
    return json.loads(lines[0])


def _bench_module():
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.pop(0)
    return bench


def test_bench_quick_names_its_device():
    """bench --quick on an explicitly requested CPU: one JSON line whose
    numbers are gated and which names the platform it ran on."""
    proc = _run_bench({"JAX_PLATFORMS": "cpu"}, args=("--quick",))
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = _json_line(proc.stdout)
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    assert rec["device_kind"] and rec["card"] is None
    assert rec["value"] > 0 and rec["int_bit_exact"] is True
    assert rec["int_frames_per_second"] > 0
    assert 0 < rec["f64ish_max_err"] <= 1e-5
    assert rec["serving_streams_float"] > 0 < rec["serving_streams_int"]


@pytest.mark.parametrize("platforms,refused", [
    (None, True), ("cuda,cpu", True), ("cpu", False)])
def test_bench_refuses_to_time_the_cpu_by_accident(monkeypatch, platforms,
                                                   refused):
    """Off-GPU the bench exits non-zero unless JAX_PLATFORMS=cpu asked for
    the CPU explicitly."""
    bench = _bench_module()
    from mfcc_jax.utils import devinfo
    monkeypatch.setattr(devinfo, "device_fields", lambda: {
        "platform": "cpu", "device_kind": "cpu", "device_count": 1,
        "card": None})
    if platforms is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    if refused:
        with pytest.raises(SystemExit) as exc:
            bench.require_gpu()
        assert exc.value.code != 0
    else:
        assert bench.require_gpu()["platform"] == "cpu"


def test_dryrun_decision_never_touches_backend():
    """_inline_mesh_ready must be decidable from env alone: in a child with
    jax importable but a poisoned devices(), the decision still returns."""
    code = (
        "import sys, types, os\n"
        "import __graft_entry__ as g\n"
        "import jax\n"
        "def boom():\n"
        "    raise AssertionError('backend touched')\n"
        "jax.devices = boom\n"
        "os.environ.pop('JAX_PLATFORMS', None)\n"
        "assert g._inline_mesh_ready(8) is False\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "os.environ['PYTHONPATH'] = %r\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=8'\n"
        "assert g._inline_mesh_ready(8) is True\n"
        "assert g._inline_mesh_ready(9) is False\n"
        "print('DECISION_OK')\n" % REPO)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "DECISION_OK" in proc.stdout
