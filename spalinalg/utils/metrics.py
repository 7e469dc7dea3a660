"""Metrics / observability tier (aux subsystem, SURVEY.md §5).

Per-op structured metrics — nnz, flops, bytes moved, achieved GB/s and
roofline fraction — via a lightweight host-side recorder with optional
JSON-lines output. The reference has no logging at all (no log crate); this
is its replacement here, feeding the bench harness (N8).

Examples
--------
>>> import numpy as np
>>> from spalinalg import CsrMatrix
>>> from spalinalg.utils import metrics
>>> rec = metrics.enable()           # global recorder; ops feed it
>>> _ = CsrMatrix.eye(4) @ np.ones(4)
>>> rec.records[-1].op, rec.records[-1].nnz
('csr_spmv', 4)
>>> metrics.disable()
"""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["OpMetrics", "MetricsRecorder", "recorder", "roofline_model",
           "DEVICE_PEAKS", "device_peaks", "gpu_card"]

# Published peak rates per device, keyed by JAX's ``device_kind``. These
# are datasheet values, not measurements: no program reaches them, so the
# bench also measures a large copy in the same run. The rates assume the
# card's full power limit; report its ``power.limit`` beside any share.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "source": "NVIDIA H100 SXM datasheet (dense, 700 W)",
        "hbm_gbps": 3350.0,
        "f32_tflops": 67.0,
        "f64_tflops": 34.0,
        "bf16_tflops": 989.0,
    },
}


def gpu_card() -> str:
    """``name, power.limit`` of the first GPU as ``nvidia-smi`` reports
    them. A card may be set below its full power limit, and then runs
    slower under load, so every number taken on it carries this line."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_peaks(device_kind: str) -> Dict:
    """Datasheet peaks of ``device_kind``; an unknown device is an error
    (a silent default would put every roofline share on the wrong
    scale)."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it "
            "to spalinalg.utils.metrics.DEVICE_PEAKS with its source"
        ) from None


@dataclass
class OpMetrics:
    op: str
    seconds: float
    nnz: int = 0
    flops: int = 0
    bytes: int = 0

    @property
    def nnz_per_s(self) -> float:
        return self.nnz / self.seconds if self.seconds else 0.0

    @property
    def gbytes_per_s(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0

    def to_dict(self) -> Dict:
        return {
            "op": self.op, "seconds": self.seconds, "nnz": self.nnz,
            "flops": self.flops, "bytes": self.bytes,
            "nnz_per_s": self.nnz_per_s, "gbytes_per_s": self.gbytes_per_s,
        }


@dataclass
class MetricsRecorder:
    """Collects :class:`OpMetrics`; optionally streams JSON lines.

    Disabled by default (zero overhead on the hot path); enable with
    :func:`enable`. The core ops (SpMV/SpMM/SpGEMM, dense and
    distributed dispatch) record through :func:`instrument`."""

    jsonl_stream: Optional[object] = None
    records: List[OpMetrics] = field(default_factory=list)
    enabled: bool = False
    _busy: bool = False  # reentrancy guard (csc -> csr mirror etc.)

    def record(self, m: OpMetrics) -> None:
        self.records.append(m)
        if self.jsonl_stream is not None:
            self.jsonl_stream.write(json.dumps(m.to_dict()) + "\n")

    @contextmanager
    def measure(self, op: str, *, nnz: int = 0, flops: int = 0,
                bytes: int = 0, sync=None):
        """Time a block (pass ``sync=result.block_until_ready`` semantics via
        a callable executed before the clock stops)."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        self.record(OpMetrics(op=op, seconds=time.perf_counter() - t0,
                              nnz=nnz, flops=flops, bytes=bytes))

    def summary(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        for m in self.records:
            s = out.setdefault(m.op, {"count": 0, "seconds": 0.0, "nnz": 0})
            s["count"] += 1
            s["seconds"] += m.seconds
            s["nnz"] += m.nnz
        return out


_GLOBAL = MetricsRecorder()


def recorder() -> MetricsRecorder:
    return _GLOBAL


def enable(jsonl_stream=None) -> MetricsRecorder:
    """Turn on per-op recording (optionally streaming JSON lines)."""
    _GLOBAL.enabled = True
    if jsonl_stream is not None:
        _GLOBAL.jsonl_stream = jsonl_stream
    return _GLOBAL


def disable() -> None:
    _GLOBAL.enabled = False
    _GLOBAL.jsonl_stream = None


def instrument(op: str, fn, *, nnz: int = 0, flops: int = 0,
               bytes: int = 0):
    """Run ``fn()``; when the global recorder is enabled, time it to
    completion (``block_until_ready``) and record an :class:`OpMetrics`.
    Nested instrumented calls (e.g. the CSC->CSR mirror) record only at
    the outermost level."""
    rec = _GLOBAL
    if not rec.enabled or rec._busy:
        return fn()
    rec._busy = True
    try:
        import jax

        t0 = time.perf_counter()
        out = fn()
        if isinstance(out, jax.core.Tracer):  # under jit: nothing to time
            return out
        jax.block_until_ready(out)
        rec.record(OpMetrics(op=op, seconds=time.perf_counter() - t0,
                             nnz=nnz, flops=flops, bytes=bytes))
        return out
    finally:
        rec._busy = False


def roofline_model(op: str, nnz: int, *, dtype_bytes: int = 4,
                   index_bytes: int = 4, rhs_cols: int = 1,
                   device_kind: str) -> Dict[str, float]:
    """Minimal-traffic roofline for the core ops (bytes that MUST move).

    SpMV: value + index + one operand element per nnz. SpMM amortises the
    index over ``rhs_cols`` operand elements. SpGEMM numeric: two value
    gathers + index per term.
    """
    if op == "spmv":
        bytes_per = dtype_bytes * 2 + index_bytes
    elif op == "spmm":
        bytes_per = dtype_bytes * (1 + 2 * rhs_cols) + index_bytes
    elif op == "spgemm":
        bytes_per = dtype_bytes * 3 + 2 * index_bytes
    else:
        bytes_per = dtype_bytes * 2 + index_bytes
    hbm = device_peaks(device_kind)["hbm_gbps"] * 1e9
    peak_nnz_s = hbm / bytes_per
    return {
        "bytes_per_nnz": float(bytes_per),
        "hbm_gbps": hbm / 1e9,
        "peak_nnz_per_s": peak_nnz_s,
        "total_bytes": float(bytes_per * nnz),
    }
