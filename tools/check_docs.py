"""Docs build check — the ``mdbook build && mdbook test`` equivalent
(reference ``x.sh:9-10``).

Validates the ``docs/`` book without an external tool:

1. structure: every page listed in ``SUMMARY.md`` exists, and every
   ``docs/*.md`` page is reachable from ``SUMMARY.md``;
2. doc-code: every ````` ```python ````` fence executes in a shared
   namespace per page (mirrors ``mdbook test`` running rustdoc fences).

Runs on the CPU backend so CI stays hermetic and fast.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

DOCS = Path(__file__).resolve().parent.parent / "docs"


def check_structure() -> list[str]:
    errors = []
    summary = (DOCS / "SUMMARY.md").read_text()
    listed = re.findall(r"\]\(([^)]+\.md)\)", summary)
    for page in listed:
        if not (DOCS / page).is_file():
            errors.append(f"SUMMARY.md links missing page: {page}")
    on_disk = {p.name for p in DOCS.glob("*.md")} - {"SUMMARY.md"}
    unlisted = on_disk - set(listed)
    for page in sorted(unlisted):
        errors.append(f"page not reachable from SUMMARY.md: {page}")
    return errors


def check_fences() -> list[str]:
    # Pages execute in SUMMARY (book) order in ONE shared namespace —
    # later pages legitimately build on names introduced earlier, the
    # same contract a reader working through the book gets.
    errors = []
    fence = re.compile(r"```python\n(.*?)```", re.DOTALL)
    summary = (DOCS / "SUMMARY.md").read_text()
    order = re.findall(r"\]\(([^)]+\.md)\)", summary)
    ns: dict = {}
    exec("import numpy as np\nimport spalinalg as sp\n", ns)
    for name in order:
        page = DOCS / name
        if not page.is_file():
            continue
        for i, block in enumerate(fence.findall(page.read_text())):
            try:
                exec(compile(block, f"{page.name}[fence {i}]", "exec"), ns)
            except Exception as e:
                errors.append(f"{page.name} fence {i}: {e!r}")
    return errors


def main() -> int:
    sys.path.insert(0, str(DOCS.parent))
    import jax

    jax.config.update("jax_platforms", "cpu")
    errors = check_structure() + check_fences()
    for e in errors:
        print(f"[docs] {e}", file=sys.stderr)
    n = len(list(DOCS.glob("*.md"))) - 1
    print(f"[docs] {n} pages, structure + python fences "
          + ("FAILED" if errors else "OK"))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
