.PHONY: test test-all test-multichip test-gpu chip-smoke ci bench native selftest clean

native:
	$(MAKE) -C native

test: native
	python -m pytest tests/ -x -q

# Whole suite under the ambient platform, no -x so every failure is listed.
test-all: native
	python -m pytest tests/ -q

# The gpu-marked tests, on a machine with an NVIDIA GPU (they skip elsewhere).
test-gpu: native
	env JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -q -m gpu

# Bring-up on one GPU: every main path at real sizes against the oracles;
# the last line is one JSON object.  Add --four-cards for the 4-GPU mesh.
chip-smoke:
	python chip_smoke.py

# Whole suite on an 8-device virtual CPU mesh, regardless of the ambient
# platform.  MFCC_REQUIRE_DEVICES makes a silent single-device degrade a
# hard failure.
test-multichip:
	env PYTHONPATH=$(CURDIR) JAX_PLATFORMS=cpu \
	  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  MFCC_REQUIRE_DEVICES=8 \
	  python -m pytest tests/ -x -q

# What CI runs (.github/workflows/ci.yml): native build + the 8-device CPU
# mesh suite + the multi-chip dryrun contract + a bench harness smoke.
ci: native test-multichip
	env PYTHONPATH=$(CURDIR) JAX_PLATFORMS=cpu \
	  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"
	env JAX_PLATFORMS=cpu python bench.py --quick

bench:
	python bench.py

selftest:
	python -m mfcc_jax.cli selftest

clean:
	$(MAKE) -C native clean
	find . -name __pycache__ -type d -exec rm -rf {} +
