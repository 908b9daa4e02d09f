#!/usr/bin/env bash
# CI-shaped check, mirroring the reference workflow's build -> reader tests
# -> integration energy tests sequence
# (reference: /root/reference/.github/workflows/tests.yml:22-37). There is
# no build step (pure Python/JAX); stages:
#   1. import / "build" sanity
#   2. reader (parser) tests      - analog of tests/readers
#   3. energy + oracle tests      - analog of tests/integration/energy
#   4. the full unit suite (moves, regimes, checkpoint, CLI, parallel)
#   5. one end-to-end example through the CLI
set -euo pipefail
cd "$(dirname "$0")"

echo "== stage 0: lint (stdlib AST analog of the reference's flint stage)"
python tools/lint.py

echo "== stage 1: import sanity + docs build-check (Sphinx-CI analog)"
python -c "import maniac_tpu; print('maniac_tpu', maniac_tpu.__version__)"
python tools/docs_check.py

echo "== stage 2: reader tests"
python -m pytest tests/test_parsers.py -q

echo "== stage 3: energy parity + reference black-box fixtures"
python -m pytest tests/test_energy.py tests/test_oracle.py \
    tests/test_triclinic.py tests/test_reference_integration.py -q

echo "== stage 4: remaining unit suite (stages 2-3 files not re-run)"
python -m pytest tests/ -q \
    --ignore=tests/test_parsers.py --ignore=tests/test_energy.py \
    --ignore=tests/test_oracle.py --ignore=tests/test_triclinic.py \
    --ignore=tests/test_reference_integration.py

echo "== stage 5: end-to-end example"
python examples/run_examples.py H2O-gcmc

echo "== CI checks passed"
