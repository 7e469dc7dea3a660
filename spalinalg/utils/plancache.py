"""One structure-keyed plan cache used by every dispatch tier.

Plans (route tables, row-reduction plans, SpGEMM expansions, CSC
mirrors, transposes) are host-built once per *concrete* structure and
reused across calls. All of them share the same caching contract,
centralised here:

- keys embed ``id()`` of the keying device arrays, so the cache must
  hold strong references to those arrays (``refs``) for as long as the
  entry lives — otherwise a recycled ``id`` aliases a dead structure;
- values built while an outer jit is tracing must be committed
  constants, not trace-scoped tracers: ``get`` runs the builder under
  ``jax.ensure_compile_time_eval()`` (escaped-tracer bug observed in
  the bench's fori_loop driver, round 2);
- eviction is FIFO with a per-cache capacity (plans are cheap to
  rebuild relative to their hit rate; LRU bookkeeping isn't worth it).

Reference scope: the reference rebuilds per call (no caching tier);
this is device-side infrastructure with no `src/` counterpart.
"""

from __future__ import annotations

from typing import Any, Callable, Hashable, Tuple

import jax

__all__ = ["StructureCache"]


class StructureCache:
    """FIFO cache mapping a structure key to a built plan.

    >>> import numpy as np
    >>> cache = StructureCache(maxsize=2)
    >>> a = np.arange(3)
    >>> built = []
    >>> def build():
    ...     built.append(1)
    ...     return "plan"
    >>> cache.get((id(a),), (a,), build)
    'plan'
    >>> cache.get((id(a),), (a,), build)   # hit: builder not re-run
    'plan'
    >>> len(built)
    1
    """

    def __init__(self, maxsize: int):
        self._maxsize = int(maxsize)
        self._data: dict = {}

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: Hashable, refs: Tuple[Any, ...],
            build: Callable[[], Any]) -> Any:
        """Return the cached value for ``key``, building it on miss.

        ``refs`` are the objects whose ``id()`` appears in ``key``;
        they are held strongly while the entry lives. ``build`` runs
        under ``ensure_compile_time_eval`` so any device arrays it
        creates are committed constants.
        """
        hit = self._data.get(key)
        if hit is not None:
            return hit[1]
        with jax.ensure_compile_time_eval():
            value = build()
        if len(self._data) >= self._maxsize:
            self._data.pop(next(iter(self._data)))
        self._data[key] = (refs, value)
        return value

    def clear(self) -> None:
        self._data.clear()
