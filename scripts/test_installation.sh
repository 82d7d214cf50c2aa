#!/usr/bin/env bash
# Installation smoke test (reference tests/test_installation.sh parity):
# installs the package into a scratch prefix (offline), then drives the
# installed `ntlink` console script on a golden dataset and checks the
# final scaffolds appear — validating setup.py metadata, package_data
# (native C sources ship with the wheel) and the console entry point.
set -euo pipefail

REPO="$(cd "$(dirname "$0")/.." && pwd)"
DATA="${NTLINK_TEST_DATA:-/root/reference/tests}"
WORK="$(mktemp -d)"
trap 'rm -rf "$WORK"' EXIT

python -m pip install --quiet --no-build-isolation --no-index \
    --prefix "$WORK/prefix" "$REPO"
SITE="$(ls -d "$WORK"/prefix/lib/python*/site-packages)"

cd "$WORK"
cp "$DATA/scaffolds_1.fa" "$DATA/long_reads_1.fa" .
PYTHONPATH="$SITE:${PYTHONPATH:-}" python - <<'PY'
import jax
jax.config.update("jax_platforms", "cpu")
import ntlink_jax
assert "prefix" in ntlink_jax.__file__, ntlink_jax.__file__
# native C sources must ship with the package (built on demand)
import os
pkg = os.path.dirname(ntlink_jax.__file__)
for src in ("native/fastxio.c", "native/chain.c"):
    assert os.path.exists(os.path.join(pkg, src)), src
from ntlink_jax.cli import main
import sys
sys.argv = ["ntlink", "scaffold", "target=scaffolds_1.fa",
            "reads=long_reads_1.fa", "w=250", "backend=numpy"]
raise SystemExit(main())
PY
test -e scaffolds_1.fa.k32.w250.z1000.ntLink.scaffolds.fa
test -x "$WORK/prefix/bin/ntlink"
echo "ntlink-jax installation OK"
