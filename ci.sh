#!/usr/bin/env bash
# CI harness — the x.sh equivalent (reference C20: fmt→check→clippy→build→
# test→doc→doctest). Python edition: syntax check → native build → unit +
# distributed-sim tests → doctest examples.
set -euo pipefail
cd "$(dirname "$0")"

echo "== syntax check =="
python -m compileall -q spalinalg tests bench.py __graft_entry__.py

echo "== native library =="
make -C spalinalg/native >/dev/null || echo "  (native build unavailable — NumPy fallbacks active)"

echo "== unit + distributed tests (8-device CPU) =="
python -m pytest tests/ -q

echo "== driver entry compile check =="
JAX_PLATFORMS=cpu python - <<'EOF'
import jax
jax.config.update("jax_platforms", "cpu")
import __graft_entry__ as g
fn, args = g.entry()
jax.jit(fn)(*args).block_until_ready()
print("entry() compiles")
EOF

echo "== multichip dry run (8 virtual devices) =="
DRYRUN_DEVICES=8 python __graft_entry__.py

echo "== docs book check (structure + python fences) =="
python tools/check_docs.py

echo "CI OK"
