"""Scatter-free segmented reduction via a host-built gather plan.

Motivation: it replaces a scatter-add / unsorted ``segment_sum`` with
gathers and dense ``sum`` reductions, so the row reduction is
deterministic and needs no atomics. Whether it beats the sorted
``segment_sum`` on a given device is measured in ``PERF.md``; the
layout (SURVEY.md N1's "padded row-bucketing"):

1. Groups (e.g. CSR rows) are padded to power-of-2 widths and binned into
   buckets; each bucket is a dense ``(R_b, W)`` gather-index matrix into the
   entry stream (out-of-group slots point at an appended zero slot).
2. A bucket reduces with a dense ``sum(axis=1)``.
3. Bucket outputs are re-gathered into group order (one small gather).
4. Groups wider than ``max_width`` are chunked and reduced hierarchically
   (``levels``); convergence is geometric, 2 levels cover 512² = 256k-wide
   rows.

The result: SpMV/SpMM/SpGEMM numeric phases are compositions of gathers,
multiplies and dense reductions only — every op in the fast class.

Padding overhead is bounded by 2× (power-of-2 buckets) and is typically
~1.2× for realistic nnz/row distributions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..dtypes import INDEX_DTYPE

__all__ = ["SegmentReducePlan", "build_segment_reduce_plan", "segment_reduce"]


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


@dataclass(frozen=True, eq=False)
class _Level:
    # Buckets: (width, gather_idx) with gather_idx (R_b, W) int32 into the
    # level's input stream extended by one zero slot at index `stream_len`.
    buckets: Tuple[Tuple[int, jax.Array], ...]
    inv_perm: jax.Array  # (n_chunks,) int32 restoring chunk/group order
    stream_len: int      # input stream length at this level


@dataclass(frozen=True, eq=False)
class SegmentReducePlan:
    """Host-built gather plan computing per-group sums of a sorted stream.

    A pytree: the index arrays are its leaves and the widths and lengths
    its static structure, so a jitted consumer takes the arrays as
    arguments instead of compiling them in as constants (index tables of
    a large matrix run to hundreds of MB)."""

    levels: Tuple[_Level, ...]
    n_groups: int
    stream_len: int  # expected input length
    padded_elems: int  # total gathered slots at level 0 (overhead metric)

    @property
    def overhead(self) -> float:
        return self.padded_elems / max(self.stream_len, 1)


jax.tree_util.register_pytree_node(
    _Level,
    lambda lv: ((tuple(g for _, g in lv.buckets), lv.inv_perm),
                (tuple(w for w, _ in lv.buckets), lv.stream_len)),
    lambda aux, ch: _Level(buckets=tuple(zip(aux[0], ch[0])),
                           inv_perm=ch[1], stream_len=aux[1]),
)
jax.tree_util.register_pytree_node(
    SegmentReducePlan,
    lambda p: ((p.levels,), (p.n_groups, p.stream_len, p.padded_elems)),
    lambda aux, ch: SegmentReducePlan(ch[0], *aux),
)


def build_segment_reduce_plan(
    sizes: Sequence[int],
    *,
    max_width: int = 512,
    min_width: int = 4,
) -> SegmentReducePlan:
    """Build the plan for groups laid out contiguously with the given sizes.

    ``sizes[g]`` is the number of stream elements in group ``g``; elements of
    group ``g`` occupy ``[offsets[g], offsets[g] + sizes[g])`` of the input.
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    n_groups = int(sizes.size)
    total = int(sizes.sum())
    levels: List[_Level] = []
    padded0 = 0

    cur_sizes = sizes
    cur_len = total
    while True:
        offsets = np.concatenate([[0], np.cumsum(cur_sizes)])[:-1]
        # Chunking: groups wider than max_width split into max_width chunks.
        n_chunks_per = np.maximum(1, -(-cur_sizes // max_width))
        widths = np.where(
            cur_sizes > max_width,
            max_width,
            np.maximum(min_width, 2 ** np.ceil(np.log2(np.maximum(cur_sizes, 1)))
                       .astype(np.int64)),
        ).astype(np.int64)

        # Flatten chunks: chunk c of group g covers
        # [offsets[g] + c*W, ...+W) clipped to the group end.
        group_of_chunk = np.repeat(np.arange(n_groups, dtype=np.int64),
                                   n_chunks_per)
        chunk_in_group = (np.arange(group_of_chunk.size, dtype=np.int64)
                          - np.repeat(np.cumsum(n_chunks_per) - n_chunks_per,
                                      n_chunks_per))
        cw = widths[group_of_chunk]
        cstart = offsets[group_of_chunk] + chunk_in_group * cw
        cend = np.minimum(cstart + cw, offsets[group_of_chunk]
                          + cur_sizes[group_of_chunk])

        # Bucket chunks by width; build gather matrices.
        buckets = []
        perm_parts = []
        order = np.argsort(cw, kind="stable")
        cw_s, cstart_s, cend_s = cw[order], cstart[order], cend[order]
        pos = 0
        while pos < cw_s.size:
            W = int(cw_s[pos])
            end = int(np.searchsorted(cw_s, W, side="right"))
            starts = cstart_s[pos:end]
            ends = cend_s[pos:end]
            idx = starts[:, None] + np.arange(W, dtype=np.int64)[None, :]
            mask = idx < ends[:, None]
            idx = np.where(mask, idx, cur_len)  # sentinel -> appended zero
            buckets.append((W, jnp.asarray(idx, dtype=INDEX_DTYPE)))
            perm_parts.append(order[pos:end])
            pos = end
        perm = np.concatenate(perm_parts) if perm_parts else np.zeros(0, np.int64)
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(perm.size, dtype=np.int64)
        levels.append(
            _Level(
                buckets=tuple(buckets),
                inv_perm=jnp.asarray(inv_perm, dtype=INDEX_DTYPE),
                stream_len=int(cur_len),
            )
        )
        if not padded0:
            padded0 = int(cw.sum())

        if np.all(n_chunks_per == 1):
            break
        cur_sizes = n_chunks_per
        cur_len = int(n_chunks_per.sum())

    return SegmentReducePlan(
        levels=tuple(levels),
        n_groups=n_groups,
        stream_len=total,
        padded_elems=padded0 or 1,
    )


def _reduce_level(level: _Level, stream: jax.Array) -> jax.Array:
    zero = jnp.zeros((1,) + stream.shape[1:], dtype=stream.dtype)
    ext = jnp.concatenate([stream, zero], axis=0)
    outs = [ext[gidx].sum(axis=1) for _, gidx in level.buckets]
    chunks = jnp.concatenate(outs, axis=0)
    return chunks[level.inv_perm]


def segment_reduce(plan: SegmentReducePlan, stream: jax.Array) -> jax.Array:
    """Apply the plan: ``out[g] = sum(stream[offsets[g]:offsets[g]+sizes[g]])``.

    ``stream`` may be ``(N,)`` or ``(N, K)`` (SpMM); reduction is along the
    stream axis only. Jit-able; all shapes static. Streams longer than
    ``plan.stream_len`` (sentinel-padded device matrices) are sliced — the
    trailing padding never belongs to any group.
    """
    if stream.shape[0] != plan.stream_len:
        stream = stream[: plan.stream_len]
    for level in plan.levels:
        stream = _reduce_level(level, stream)
    return stream
