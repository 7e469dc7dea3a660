"""On-disk persistence for host-built plans.

Supernodal factorization plans cost seconds of host time per structure
(ordering, symbolic analysis, index plans). Deployments that factor the
same sparsity across processes — and the bench harness itself — reload
them from disk keyed by a structure hash instead.

Storage: a NON-EXECUTABLE ``npz`` archive (a pickle would execute
arbitrary code on load from a shared or tampered cache directory). Plan dataclasses are flattened to arrays +
a JSON field manifest; reconstruction goes through an explicit class
allowlist with ``object.__new__`` — no code in the file is ever
executed. Plans hold host (NumPy) data only. Any load failure (missing attribute
after a refactor, version bump, corrupt file) silently falls back to
a rebuild; the cache is an optimisation, never a correctness
dependency.

The cache key folds in the plan-layout version AND a hash of the
native host-kernel source (the symbolic phase lives there; a rebuilt
library must not serve plans built by the old one). Total size is capped
(``$SPALINALG_PLAN_CACHE_MAX_MB``, default 2048) with LRU eviction —
loads refresh mtime, saves evict oldest-first.

Location: ``$SPALINALG_PLAN_CACHE`` (a directory; ``0``/``off``
disables), default ``~/.cache/spalinalg/plans``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os

import numpy as np

__all__ = ["plan_cache_dir", "load_or_build"]

_VERSION = 9  # bump when plan layouts or build algorithms change
_native_hash_cache = None


def _native_hash() -> str:
    global _native_hash_cache
    if _native_hash_cache is None:
        src = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "native", "src",
            "host_kernels.cpp")
        try:
            with open(src, "rb") as f:
                _native_hash_cache = hashlib.sha256(
                    f.read()).hexdigest()[:16]
        except OSError:
            _native_hash_cache = "nonative"
    return _native_hash_cache


def plan_cache_dir():
    env = os.environ.get("SPALINALG_PLAN_CACHE", "")
    if env.lower() in ("0", "off", "none"):
        return None
    path = env or os.path.expanduser("~/.cache/spalinalg/plans")
    try:
        os.makedirs(path, exist_ok=True)
        return path
    except OSError:
        return None


def _structure_key(kind: str, arrays, scalars) -> str:
    h = hashlib.sha256()
    h.update(f"{kind}:v{_VERSION}:{_native_hash()}".encode())
    for s in scalars:
        h.update(str(s).encode())
        h.update(b";")
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------
# Non-executable (de)serialisation: plans flatten to {name: ndarray}
# plus a JSON manifest; classes come from an allowlist, never the file.
# ---------------------------------------------------------------------

def _plan_classes():
    from ..linalg.supernodal import SupernodalPlan, _Bucket
    from ..linalg.symbolic import SupernodalSymbolic

    return {"SupernodalPlan": SupernodalPlan, "_Bucket": _Bucket,
            "SupernodalSymbolic": SupernodalSymbolic}


def _encode(key, v, arrays, meta):
    if v is None or isinstance(v, (bool, int, float, str)):
        meta[key] = {"k": "s", "v": v}
    elif isinstance(v, np.ndarray):
        meta[key] = {"k": "a"}
        arrays["a:" + key] = v
    elif isinstance(v, np.generic):
        meta[key] = {"k": "s", "v": v.item()}
    elif isinstance(v, (list, tuple)):
        meta[key] = {"k": "l" if isinstance(v, list) else "t",
                     "n": len(v)}
        for i, e in enumerate(v):
            _encode(f"{key}.{i}", e, arrays, meta)
    elif dataclasses.is_dataclass(v):
        name = type(v).__name__
        if name not in _plan_classes():
            raise TypeError(f"unregistered plan class {name}")
        meta[key] = {"k": "p", "cls": name}
        for f in dataclasses.fields(v):
            fv = getattr(v, f.name)
            if isinstance(fv, dict):  # runtime bake caches: not persisted
                fv = None
            _encode(f"{key}/{f.name}", fv, arrays, meta)
    else:
        raise TypeError(f"unserialisable field {key}: {type(v)}")


def _decode(key, arrays, meta):
    m = meta[key]
    k = m["k"]
    if k == "s":
        return m["v"]
    if k == "a":
        return arrays["a:" + key]
    if k in ("l", "t"):
        seq = [_decode(f"{key}.{i}", arrays, meta)
               for i in range(m["n"])]
        return seq if k == "l" else tuple(seq)
    if k == "p":
        cls = _plan_classes()[m["cls"]]
        obj = object.__new__(cls)
        for f in dataclasses.fields(cls):
            fkey = f"{key}/{f.name}"
            if fkey not in meta:
                # field added since this file was written: the stored
                # plan predates the current layout — rebuild rather
                # than silently None-fill (load_or_build catches this)
                raise KeyError(f"stale plan layout: missing {fkey}")
            object.__setattr__(obj, f.name, _decode(fkey, arrays, meta))
        return obj
    raise ValueError(f"bad manifest kind {k!r}")


def _save(path, plan) -> None:
    arrays, meta = {}, {}
    _encode("plan", plan, arrays, meta)
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def _load(path):
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return _decode("plan", arrays, meta)


def _evict(cdir) -> None:
    cap = float(os.environ.get("SPALINALG_PLAN_CACHE_MAX_MB", "2048"))
    cap_bytes = int(cap * 1e6)
    try:
        entries = []
        total = 0
        with os.scandir(cdir) as it:
            for e in it:
                if not e.is_file():
                    continue
                st = e.stat()
                entries.append((st.st_mtime, st.st_size, e.path))
                total += st.st_size
        if total <= cap_bytes:
            return
        for _mt, size, p in sorted(entries):
            try:
                os.remove(p)
            except OSError:
                continue
            total -= size
            if total <= cap_bytes:
                break
    except OSError:
        pass


def load_or_build(kind, arrays, scalars, build):
    """Return the cached plan for this structure, or build+store it.

    ``arrays``/``scalars`` define the structure identity; ``build`` is
    the host builder, returning host (NumPy) data only.
    """
    cdir = plan_cache_dir()
    if cdir is None:
        return build()
    path = os.path.join(cdir, _structure_key(kind, arrays, scalars)
                        + ".npz")
    if os.path.exists(path):
        try:
            plan = _load(path)
            os.utime(path)  # LRU recency
            return plan
        except Exception:
            pass  # corrupt / stale layout: rebuild below
    plan = build()
    try:
        _save(path, plan)
        _evict(cdir)
    except Exception:
        pass
    return plan
