"""Frozen configuration (SURVEY.md §5 "Config / flag system").

The reference has no config system — behavior is fixed and the only knobs
are the scalar generics (`scalar.rs:56-57`). This build needs a small,
explicit, jit-static config: dtypes, bucket boundaries, tolerances,
partitioning axis. Which kernel runs is not a setting: each op picks its
path from what it can observe (platform, dtype, shape). It is a frozen
(hashable) dataclass threaded explicitly — never read from the
environment inside compute code.

Examples
--------
>>> from spalinalg.config import Config, current_config, use
>>> current_config().partition_axis
'rows'
>>> with use(Config(partition_axis="shards")) as cfg:
...     print(current_config().partition_axis)
shards
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace

import numpy as np


@dataclass(frozen=True)
class Config:
    """Static knobs for kernel planning and distribution."""

    # Value dtype for newly created matrices when unspecified.
    default_dtype: str = "float64"
    # Segmented-reduction plan: maximum ELL bucket width before a row is
    # split into chunks and reduced hierarchically.
    max_bucket_width: int = 512
    # Minimum bucket width (pads very short rows up to this; keeps the
    # number of XLA ops per plan small).
    min_bucket_width: int = 4
    # Numerical tolerance for parity checks against the CPU oracle.
    rtol_f32: float = 1e-5
    rtol_f64: float = 1e-12
    # Distribution: partition axis name used in meshes built by
    # spalinalg.parallel.
    partition_axis: str = "rows"

    def with_(self, **kw) -> "Config":
        return replace(self, **kw)

    @property
    def np_default_dtype(self):
        return np.dtype(self.default_dtype)


_DEFAULT = Config()
_STACK = [_DEFAULT]


def default_config() -> Config:
    return _DEFAULT


def current_config() -> Config:
    """The active config: kernel dispatch, plan builders and the
    parallel tier consult this (innermost :func:`use` scope wins)."""
    return _STACK[-1]


@contextmanager
def use(cfg: Config):
    """Scope a config: ``with config.use(cfg.with_(rtol_f32=1e-4)): ...``"""
    _STACK.append(cfg)
    try:
        yield cfg
    finally:
        _STACK.pop()
