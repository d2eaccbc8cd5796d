.PHONY: test test-fast test-gpu smoke doctest bench baseline lint

# Three serial shards, each a fresh process: the XLA CPU compiler
# segfaults after a few hundred accumulated in-process compilations
# (cumulative, not test-specific; every crashing test passes in a fresh
# process).
test:
	python -m pytest tests/test_[a-f]*.py -q
	python -m pytest tests/test_[g-m]*.py -q
	python -m pytest tests/test_[n-z]*.py -q
	python -m pytest --doctest-modules littlemcmc_tpu -q

test-fast:
	python -m pytest tests/ -q -x -k "not recovery and not parity"

# Run the tests marked `gpu` on a machine with an NVIDIA GPU (they skip
# under the default CPU suite).
test-gpu:
	LMC_TEST_PLATFORM=gpu python -m pytest -m gpu tests/ -q -rs

# The main path on one GPU, end to end (exits non-zero without a GPU).
smoke:
	python chip_smoke.py

doctest:
	python -m pytest --doctest-modules littlemcmc_tpu -q

bench:
	python bench.py

baseline:
	python scripts/measure_reference_baseline.py

# Enforced in CI (lint.yml): black --check, pydocstyle, mypy. Locally this
# image has none of them; compileall is the offline floor.
lint:
	python -m compileall -q littlemcmc_tpu tests bench.py chip_smoke.py __graft_entry__.py
	@command -v black >/dev/null && black --check --line-length 88 littlemcmc_tpu tests bench.py __graft_entry__.py || echo "black not installed (CI runs it)"
	@command -v pydocstyle >/dev/null && pydocstyle littlemcmc_tpu || echo "pydocstyle not installed (CI runs it)"
	@command -v mypy >/dev/null && mypy littlemcmc_tpu || echo "mypy not installed (CI runs it)"

validate:
	python scripts/deep_validation.py

suite:
	python scripts/bench_suite.py

scaling:
	python scripts/scaling_bench.py
