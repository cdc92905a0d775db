"""chip_smoke.py: the GPU bring-up check.

On the CPU it must refuse to run (non-zero exit, no result line), and alone
in a directory without the package it must fail too.  Its phases are plain
functions of a device and a size, so they run here at tiny sizes on an
explicit CPU device; the ``gpu``-marked twin runs them on the card
(``make test-gpu``)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

TINY = {
    "float": (chip_smoke.phase_float, dict(S=3, T=2000)),
    "int": (chip_smoke.phase_int, dict(S=3, T=2000)),
    "f64ish": (chip_smoke.phase_f64ish, dict(S=2, T=1500)),
    "streaming": (chip_smoke.phase_streaming,
                  dict(S=4, C=256, n_chunks=4, steps=2)),
    "server": (chip_smoke.phase_server, dict(clients=2, seconds=0.25)),
}


def _run(args, cwd, env):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_to_run_on_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = _run(["chip_smoke.py"], REPO, env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run(["chip_smoke.py"], str(tmp_path), env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("phase", list(TINY))
def test_phase_on_cpu_device(phase):
    fn, kw = TINY[phase]
    res = fn(jax.devices("cpu")[0], **kw)
    assert res["shape"]
    for key, value in res.items():
        if key.startswith("max_err"):
            assert 0 <= value <= chip_smoke.FLOAT_GATE


def test_four_card_path_on_virtual_devices():
    """The --four-cards path on 4 of the suite's virtual CPU devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    lines = chip_smoke.phase_four_cards(jax.devices()[:4], S=4, T=2000,
                                        C=512, n_chunks=2)
    assert [l["mesh"] for l in lines] == ["(4, 1)", "(2, 2)"]
    for line in lines:
        assert line["batch_int_frames_per_s"] > 0
        assert line["halo_float_err"] <= chip_smoke.FLOAT_GATE


def test_entry_kernel_count():
    hlo = ("HloModule m\n\n%fused (p: f32[2]) -> f32[2] {\n"
           "  %p = f32[2] parameter(0)\n"
           "  ROOT %n = f32[2] negate(%p)\n}\n\n"
           "ENTRY %main (a: f32[2]) -> (f32[2], f32[2]) {\n"
           "  %a = f32[2] parameter(0)\n"
           "  %c = f32[] constant(1)\n"
           "  %f = f32[2] fusion(%a), kind=kLoop, calls=%fused\n"
           "  %g = f32[2]{0} custom-call(%f), custom_call_target=\"x\"\n"
           "  ROOT %t = (f32[2], f32[2]) tuple(%f, %g)\n}\n")
    assert chip_smoke.entry_kernel_count(hlo) == 2
    compiled = jax.jit(lambda x: (x * 2).sum()).lower(
        jax.numpy.ones(8)).compile().as_text()
    assert chip_smoke.entry_kernel_count(compiled) >= 1


def test_main_prints_the_contract(monkeypatch, capsys):
    """Line before the last names the card; the last is the JSON result."""
    cpu = jax.devices("cpu")
    monkeypatch.setattr(chip_smoke, "phase_device", lambda expect=None: cpu)
    monkeypatch.setattr(chip_smoke, "card_info", lambda: "TEST CARD, 1.00 W")
    from mfcc_jax import compile_cache
    monkeypatch.setattr(compile_cache, "enable", lambda: None)
    for name in TINY:
        monkeypatch.setattr(chip_smoke, f"phase_{name}",
                            lambda dev, n=name: {"shape": n, "max_err": 0})
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "card: TEST CARD, 1.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "cpu", "kind": cpu[0].device_kind, "count": len(cpu)}}
    phases = [l for l in lines if l.startswith("[")]
    assert len(phases) == 1 + len(TINY)
    assert all('card="TEST CARD, 1.00 W"' in l for l in phases)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", list(TINY))
def test_phase_on_gpu(gpu_device, phase):
    fn, kw = TINY[phase]
    res = fn(gpu_device, **kw)
    for key, value in res.items():
        if key.startswith("max_err"):
            assert 0 <= value <= chip_smoke.FLOAT_GATE
