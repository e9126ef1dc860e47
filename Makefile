# Developer entry points (the reference ships complete generated makefiles;
# SURVEY.md §2.18).  `make test` is the path CI uses; `python chip_smoke.py`
# is the GPU smoke run.

PY ?= python

.PHONY: install test selftest soak soak-quick sanitize native clean

install:
	$(PY) -m pip install -e . --no-build-isolation

test:
	$(PY) -m pytest tests/ -x -q

selftest:
	$(PY) -m mjpeg423_tpu.cli selftest

# Randomized cross-path equivalence + corruption soaks (CPU virtual mesh).
soak:
	$(PY) scripts/parity_soak.py 30
	$(PY) scripts/fuzz_native.py 30

# Bounded (~2 min) seeded soak for CI: the seed is printed first so any
# failure reproduces with `make soak-quick SOAK_SEED=<seed>`.
soak-quick:
	@SEED=$${SOAK_SEED:-$$(date +%s)}; echo "soak-quick seed=$$SEED"; \
	$(PY) scripts/parity_soak.py 5 $$SEED && \
	$(PY) scripts/fuzz_native.py 10 $$SEED && \
	$(PY) scripts/lanes_sweep.py 300 $$SEED

# ASan/UBSan soak of the native codec's SIMD paths (valid + corrupted
# streams; ctypes cannot load a sanitized .so, hence the C harness).
sanitize:
	gcc -O1 -g -std=c11 -fwrapv -march=native -fopenmp \
	    -fsanitize=address,undefined -fno-sanitize-recover=all \
	    -o /tmp/mj_san_native scripts/sanitize_native.c
	/tmp/mj_san_native

# Force a rebuild of the native entropy codec (normally on-demand at import).
native:
	rm -rf mjpeg423_tpu/native/_build
	$(PY) -c "from mjpeg423_tpu.native import centropy; print('native codec:', centropy.native_available())"

clean:
	rm -rf build dist *.egg-info .oracle_build .jax_cache
	rm -rf mjpeg423_tpu/native/_build
	find . -name __pycache__ -type d -prune -exec rm -rf {} \;
