"""What a measurement ran on, and how it was timed.

Every number the bench and the chip smoke test print names its device
(JAX's platform, device kind and count) and, on an NVIDIA card, the card's
name and power limit as ``nvidia-smi`` reports them: a card set below its
maximum power runs slower under load.
"""

from __future__ import annotations

import subprocess
import time


def card_info() -> str:
    """``"<name>, <power limit>"`` of the first NVIDIA card; raises when
    ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_fields() -> dict:
    """platform / device_kind / device_count of the default backend, plus
    the card's name and power limit (None off NVIDIA cards)."""
    import jax
    devs = jax.devices()
    card = None
    if devs[0].platform == "gpu":
        card = card_info()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs), "card": card}


def timed(fn, *args, iters: int = 5):
    """(first-call seconds incl. compile, steady seconds per call, output).
    Every call ends in ``block_until_ready``: JAX returns before the device
    finishes, and a timing without it measures the enqueue."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jax.block_until_ready(fn(*args))
    return first, (time.perf_counter() - t0) / iters, out


def step_seconds(sm, chunk, S: int, steps: int) -> float:
    """Seconds per ``StreamingMFCC.step`` in a steady chain of ``steps``
    steps over S streams.  Two untimed steps come first: jit compiles once
    for the fresh state from ``init`` and once more for the committed
    device arrays a step returns."""
    import jax
    state = sm.init(S)
    for _ in range(2):
        feats, _, state = sm.step(chunk, state)
    jax.block_until_ready((feats, state))
    t0 = time.perf_counter()
    for _ in range(steps):
        feats, _, state = sm.step(chunk, state)
    jax.block_until_ready((feats, state))
    return (time.perf_counter() - t0) / steps
