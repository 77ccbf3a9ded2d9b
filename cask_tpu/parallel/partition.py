"""Host-side matrix partitioning for multi-chip execution (BASELINE T7).

cask had no multi-accelerator story (single DFE); the distribution layer
is specified by BASELINE.json: row/block-partition across chips, halo
vector segments exchanged with ``jax.lax`` collectives overlapped with
local compute.

Partitioning contract (shape-uniform so one ``shard_map`` program serves
every shard): ``P`` contiguous row blocks of identical padded size
``mloc``; per-shard index arrays padded to the max across shards with
structural zeros (row 0 / col 0 / value 0 — harmless in segment sums).

Two plans are built here:

- :class:`CooPartition` — any matrix.  Entries are split per shard into
  *interior* (column owned locally) and *exterior* (column elsewhere);
  the exterior part indexes an all-gathered x.  Interior compute has no
  data dependence on the collective, which is what lets XLA overlap the
  all-gather with it.
- :class:`DiaPartition` — banded matrices (the ≥10M-row config-5 class).
  Each shard holds its slice of every packed diagonal; only ``lo``/``hi``
  edge elements are needed from the ring neighbors (`ppermute`), and the
  big diagonal FMA work depends only on local x — the halo fix-up
  touches just the first/last rows.  This is SpMV's ring-exchange analog
  of sequence parallelism (SURVEY.md §2 parallelism inventory).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import numpy as np

from cask_tpu.formats.matrix import CSR

_INT = np.int32


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CooPartition:
    """Row-partitioned COO with interior/exterior split (general matrices)."""

    # interior: columns local to the shard (remapped to local indices)
    int_data: jax.Array  # (P, Ei)
    int_row: jax.Array  # (P, Ei) local row
    int_col: jax.Array  # (P, Ei) local col
    # exterior: columns owned by other shards (global indices into
    # the padded gathered vector of length P*mloc)
    ext_data: jax.Array  # (P, Ee)
    ext_row: jax.Array  # (P, Ee) local row
    ext_col: jax.Array  # (P, Ee) padded-global col
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nshards: int = dataclasses.field(metadata=dict(static=True))
    mloc: int = dataclasses.field(metadata=dict(static=True))

    def device_put(self, device=None) -> "CooPartition":
        return jax.tree.map(lambda x: jax.device_put(x, device), self)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DiaPartition:
    """Row-partitioned diagonal pack + ring halo (banded matrices).

    ``vals[p, d, r]`` is ``A[p*mloc + r, p*mloc + r + offsets[d]]``.
    Entries outside the band go into an embedded :class:`CooPartition`
    remainder (may be empty).
    """

    vals: jax.Array  # (P, D, mloc)
    remainder: Optional[CooPartition]  # exterior-style COO or None
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nshards: int = dataclasses.field(metadata=dict(static=True))
    mloc: int = dataclasses.field(metadata=dict(static=True))

    @property
    def halo_lo(self) -> int:
        return -min(min(self.offsets), 0)

    @property
    def halo_hi(self) -> int:
        return max(max(self.offsets), 0)

    def device_put(self, device=None) -> "DiaPartition":
        return jax.tree.map(lambda x: jax.device_put(x, device), self)


def _pad_rows(groups, P, width, fill=0, dtype=_INT):
    out = np.full((P, width), fill, dtype=dtype)
    for p, g in enumerate(groups):
        out[p, : g.shape[0]] = g
    return out


def partition_coo(a: CSR, nshards: int, *, mloc: Optional[int] = None) -> CooPartition:
    """Row-partition any CSR into the interior/exterior COO plan.

    ``mloc`` overrides the per-shard row count (callers embedding the
    remainder of a block partition must match the block plan's scalar
    row split)."""
    m, n = a.shape
    P = nshards
    mloc = mloc if mloc is not None else _ceil_div(m, P)
    if mloc * P < m:
        raise ValueError(f"mloc ({mloc}) too small for {m} rows / {P} shards")
    if n > P * mloc:
        # x is partitioned like the rows; a wider matrix would index the
        # gathered vector out of range
        raise ValueError(
            f"partition_coo requires n ({n}) <= nshards*mloc ({P * mloc}); "
            "pad the matrix columns or partition the transpose"
        )
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))

    owner_row = rows // mloc
    owner_col = indices // mloc  # x is partitioned identically (square-ish)
    interior = owner_row == owner_col

    gi = [None] * P
    ge = [None] * P
    for p in range(P):
        mine = owner_row == p
        mi = mine & interior
        me = mine & ~interior
        gi[p] = (data[mi], rows[mi] - p * mloc, indices[mi] - p * mloc)
        # exterior columns as *padded global* index: shard q, local c →
        # q*mloc + c (identity here since x layout is contiguous padded)
        ge[p] = (data[me], rows[me] - p * mloc, indices[me])

    Ei = max((g[0].shape[0] for g in gi), default=0) or 1
    Ee = max((g[0].shape[0] for g in ge), default=0) or 1
    return CooPartition(
        int_data=jax.numpy.asarray(_pad_rows([g[0] for g in gi], P, Ei, 0.0, data.dtype)),
        int_row=jax.numpy.asarray(_pad_rows([g[1] for g in gi], P, Ei)),
        int_col=jax.numpy.asarray(_pad_rows([g[2] for g in gi], P, Ei)),
        ext_data=jax.numpy.asarray(_pad_rows([g[0] for g in ge], P, Ee, 0.0, data.dtype)),
        ext_row=jax.numpy.asarray(_pad_rows([g[1] for g in ge], P, Ee)),
        ext_col=jax.numpy.asarray(_pad_rows([g[2] for g in ge], P, Ee)),
        shape=(m, n),
        nshards=P,
        mloc=mloc,
    )


def partition_dia(a: CSR, nshards: int, *, min_density: float = 0.10,
                  max_diags: int = 256, max_halo: Optional[int] = None) -> DiaPartition:
    """Row-partition a banded CSR into per-shard diagonal slices.

    Diagonals whose |offset| exceeds ``max_halo`` (default ``mloc``) spill
    to the remainder — a halo wider than a whole shard would need
    multi-hop exchange, which the all-gather remainder already covers.
    """
    m, n = a.shape
    if m != n:
        raise ValueError("DiaPartition requires a square matrix")
    P = nshards
    mloc = _ceil_div(m, P)
    max_halo = max_halo if max_halo is not None else mloc

    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    offs = indices - rows

    uniq, counts = np.unique(offs, return_counts=True)
    diag_len = np.minimum(np.minimum(m, n - uniq), np.minimum(n, m + uniq))
    density = counts / np.maximum(diag_len, 1)
    keep = (density >= min_density) & (np.abs(uniq) <= max_halo)
    if keep.sum() > max_diags:
        keep &= counts >= np.sort(counts[keep])[-max_diags]
    kept = uniq[keep]
    if kept.size == 0:
        kept = np.array([0], dtype=np.int64)

    in_dia = np.isin(offs, kept)
    D = kept.size
    vals = np.zeros((P, D, mloc), dtype=data.dtype)
    d_ids = np.searchsorted(kept, offs[in_dia])
    r = rows[in_dia]
    vals[r // mloc, d_ids, r % mloc] = data[in_dia]

    rem = None
    n_rem = int((~in_dia).sum())
    if n_rem:
        from cask_tpu.formats.convert import coo_from_arrays, coo_to_csr

        rem_csr = coo_to_csr(
            coo_from_arrays(data[~in_dia], rows[~in_dia], indices[~in_dia], (m, n))
        )
        rem = partition_coo(rem_csr, P)

    return DiaPartition(
        vals=jax.numpy.asarray(vals),
        remainder=rem,
        offsets=tuple(int(o) for o in kept),
        shape=(m, n),
        nshards=P,
        mloc=mloc,
    )


def stencil_dia_partition(nx: int, ny: Optional[int] = None, *, nshards: int,
                          dtype=np.float32) -> DiaPartition:
    """Formulaic DiaPartition of the 5-point Laplacian — no CSR build.

    The ≥10M-row config-5 class needs a partition plan every CI round,
    but materializing the 50M-entry CSR first costs
    a minute of numpy; the stencil's diagonals are formulaic, so the
    sharded pack is written directly (bit-identical to
    ``partition_dia(generate.stencil_2d(nx, ny), nshards)``,
    covered by a small-size parity test)."""
    ny = ny or nx
    n = nx * ny
    P = nshards
    mloc = _ceil_div(n, P)
    offsets = tuple(sorted({-ny, -1, 0, 1, ny}))
    g = np.arange(P * mloc, dtype=np.int64)  # global row ids (padded)
    in_range = g < n
    col_in_row = g % ny
    vals = np.zeros((len(offsets), P * mloc), dtype=dtype)
    for d, off in enumerate(offsets):
        if off == 0:
            ok = in_range
            v = 4.0
        elif off == 1:
            ok = in_range & (g + 1 < n) & (col_in_row != ny - 1)
            v = -1.0
        elif off == -1:
            ok = in_range & (g >= 1) & (col_in_row != 0)
            v = -1.0
        elif off == ny:
            ok = in_range & (g + ny < n)
            v = -1.0
        else:
            ok = in_range & (g >= ny)
            v = -1.0
        vals[d, ok] = v
    return DiaPartition(
        vals=jax.numpy.asarray(
            np.ascontiguousarray(vals.reshape(len(offsets), P, mloc).transpose(1, 0, 2))
        ),
        remainder=None,
        offsets=offsets,
        shape=(n, n),
        nshards=P,
        mloc=mloc,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BdiaPartition:
    """Block-row-partitioned BDIA pack + ring halo (the tuned-BSR block
    path running config 5).

    Shard ``p`` owns block rows ``[p·nbloc, (p+1)·nbloc)`` of the global
    block matrix as a shape-uniform BDIA pack (shared kept offsets across
    shards; trailing shards zero-padded).
    The halo is ``lo_b``/``hi_b`` *block* offsets of x exchanged with
    ring neighbors (``lo_b·bc`` / ``hi_b·bc`` scalar entries); interior
    compute reads only local x (structural-zero pads), so it has no data
    dependence on the collective — the overlap invariant.

    ``head_vals``/``tail_vals`` are host-extracted edge value windows
    (zeroed where the term is interior) that make the post-halo fixups
    regular component-plane FMAs: for pair ``j = (c, d)``

        head[r, i]  += head_vals[r, j, i] · left_c[i + d + lo_b]   (d < 0)
        tail[r, ih] += tail_vals[r, j, ih] · right_c[ih − (hi_b − d)] (d > 0)

    with ``i`` over the first ``lo_b`` block rows and ``ih`` over the
    last ``hi_b``.  Block diagonals wider than one shard (|d| > nbloc)
    spill to the embedded :class:`CooPartition` remainder (single-hop
    ring discipline, same as :func:`partition_dia`'s ``max_halo``).
    """

    vals: jax.Array  # (P, br, npairs, nbloc)
    head_vals: jax.Array  # (P, br, npairs, max(lo_b, 1))
    tail_vals: jax.Array  # (P, br, npairs, max(hi_b, 1))
    remainder: Optional[CooPartition]
    block_offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    blocksize: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nshards: int = dataclasses.field(metadata=dict(static=True))
    mloc: int = dataclasses.field(metadata=dict(static=True))  # scalar rows/shard
    nbloc: int = dataclasses.field(metadata=dict(static=True))  # block rows/shard

    @property
    def halo_lo_b(self) -> int:
        return -min(min(self.block_offsets), 0)

    @property
    def halo_hi_b(self) -> int:
        return max(max(self.block_offsets), 0)

    @property
    def npairs(self) -> int:
        return int(self.vals.shape[2])

    @property
    def pairs(self) -> Tuple[Tuple[int, int], ...]:
        bc = self.blocksize[1]
        return tuple((c, d) for d in self.block_offsets for c in range(bc))

    def device_put(self, device=None) -> "BdiaPartition":
        return jax.tree.map(lambda x: jax.device_put(x, device), self)


def _bdia_edge_windows(vals: np.ndarray, kept: np.ndarray, bc: int,
                       nbloc: int):
    """Host-extract the (head_vals, tail_vals) fixup windows from a
    packed ``(P, br, npairs, nbloc)`` vals array (zeroed where the term
    is interior — see :class:`BdiaPartition`)."""
    P, br, npairs = vals.shape[:3]
    dtype = vals.dtype
    lo_b = int(-min(kept.min(), 0))
    hi_b = int(max(kept.max(), 0))
    offs_per_pair = np.repeat(kept, bc)  # d of pair j
    wl, wh = max(lo_b, 1), max(hi_b, 1)
    head_vals = np.zeros((P, br, npairs, wl), dtype=dtype)
    w = min(lo_b, nbloc)
    head_vals[..., :w] = vals[..., :w]
    head_vals *= (np.arange(wl)[None, :] < -offs_per_pair[:, None]).astype(dtype)

    tail_vals = np.zeros((P, br, npairs, wh), dtype=dtype)
    if hi_b:
        tail_vals[:] = vals[..., nbloc - hi_b : nbloc]
        tail_vals *= (np.arange(wh)[None, :] >= (hi_b - offs_per_pair)[:, None]
                      ).astype(dtype)
    return head_vals, tail_vals


def partition_bdia(a, nshards: int, blocksize: Optional[Tuple[int, int]] = None,
                   *, min_density: float = 0.10,
                   max_block_diags: int = 64) -> BdiaPartition:
    """Block-row-partition a BSR/CSR matrix into per-shard BDIA packs.

    Square blocks only (x is partitioned like the rows).  Kept block
    diagonals are chosen *globally* (one shape-uniform shard program);
    everything else — sparse block diagonals, blocks beyond the
    single-hop halo — spills to the scalar COO remainder.
    """
    from cask_tpu.formats.matrix import BSR

    if isinstance(a, CSR):
        if blocksize is None:
            raise ValueError("partition_bdia on CSR needs an explicit blocksize")
        from cask_tpu.formats.convert import csr_to_bsr

        a = csr_to_bsr(a, blocksize)
    assert isinstance(a, BSR)
    br, bc = a.blocksize
    if br != bc:
        raise ValueError("partition_bdia needs square blocks (row partition "
                         "owns x like the rows)")
    m, n = a.shape
    if m != n:
        raise ValueError("partition_bdia requires a square matrix")
    P = nshards
    nbr = a.n_block_rows
    nbloc = _ceil_div(nbr, P)
    mloc = nbloc * br

    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data)
    ib = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(indptr))
    d = indices - ib

    # global kept-offset choice (same rule as bdia_plan) + halo guard
    uniq, counts = np.unique(d, return_counts=True)
    diag_len = np.minimum(np.minimum(nbr, nbr - uniq), np.minimum(nbr, nbr + uniq))
    density = counts / np.maximum(diag_len, 1)
    keep = (density >= min_density) & (np.abs(uniq) <= nbloc)
    if keep.sum() > max_block_diags:
        keep &= counts >= np.sort(counts[keep])[-max_block_diags]
    kept = uniq[keep]
    if kept.size == 0:
        kept = np.array([0], dtype=np.int64)
    in_dia = np.isin(d, kept)

    npairs = kept.size * bc
    vals = np.zeros((P, br, npairs, nbloc), dtype=data.dtype)
    kb = np.nonzero(in_dia)[0]
    if kb.size:
        i = ib[kb]
        dpos = np.searchsorted(kept, d[kb])
        c_rng = np.arange(bc)
        vals[
            (i // nbloc)[:, None],
            :,
            dpos[:, None] * bc + c_rng[None, :],
            (i % nbloc)[:, None],
        ] = data[kb].transpose(0, 2, 1)

    head_vals, tail_vals = _bdia_edge_windows(vals, kept, bc, nbloc)

    # remainder: spilled blocks as scalar COO over the same row split
    rem = None
    rb = np.nonzero(~in_dia)[0]
    if rb.size:
        from cask_tpu.formats.convert import coo_from_arrays, coo_to_csr

        ri, rj = ib[rb], indices[rb]
        rr = (ri[:, None, None] * br + np.arange(br)[None, :, None])
        rc = (rj[:, None, None] * bc + np.arange(bc)[None, None, :])
        rr = np.broadcast_to(rr, (rb.size, br, bc)).ravel()
        rc = np.broadcast_to(rc, (rb.size, br, bc)).ravel()
        rv = data[rb].ravel()
        inside = (rr < m) & (rc < n) & (rv != 0)
        rem_csr = coo_to_csr(coo_from_arrays(rv[inside], rr[inside],
                                             rc[inside], (m, n)))
        rem = partition_coo(rem_csr, P, mloc=mloc)

    return BdiaPartition(
        vals=jax.numpy.asarray(vals),
        head_vals=jax.numpy.asarray(head_vals),
        tail_vals=jax.numpy.asarray(tail_vals),
        remainder=rem,
        block_offsets=tuple(int(o) for o in kept),
        shape=(m, n),
        blocksize=(br, bc),
        nshards=P,
        mloc=mloc,
        nbloc=nbloc,
    )


def _fem_formula_val(i, dpos, r, c, dof: int):
    """Deterministic pseudo-values for the formulaic FEM builders —
    cheap, vectorized over block rows ``i`` (numpy or jax.numpy), and
    identical in the direct packs, the device builder and the reference
    BSR.  The product is reduced mod 2003 before it is formed, so 32-bit
    device integers do not overflow, and the scale is a power of two, so
    every value is exact in f32 and f64 alike."""
    h = ((i % 2003) * (1000003 % 2003) + int(dpos) * 7919
         + int(r) * 211 + int(c) * 37) % 2003
    return h / 2048.0 - 0.5


def _fem_offset_mask(g, off: int, ny: int, nbr: int):
    """Which block rows carry a neighbor at block offset ``off`` in the
    5-point grid (mirrors :func:`stencil_dia_partition`'s edge rules)."""
    in_range = g < nbr
    col = g % ny
    if off == 0:
        return in_range
    if off == 1:
        return in_range & (g + 1 < nbr) & (col != ny - 1)
    if off == -1:
        return in_range & (g >= 1) & (col != 0)
    if off == ny:
        return in_range & (g + ny < nbr)
    return in_range & (g >= ny)


def fem_bdia_partition(nx: int, ny: Optional[int] = None, *, dof: int = 4,
                       nshards: int, dtype=np.float32) -> BdiaPartition:
    """Formulaic BdiaPartition of the dof-block 5-point FEM matrix — no
    CSR/BSR materialization (the BDIA analog of
    :func:`stencil_dia_partition`; config-5 CI and the scaling job need
    a ≥10M-row block plan every round without minutes of numpy).

    Structurally identical to ``partition_bdia(fem_blocks-like BSR,
    nshards)`` with deterministic pseudo-values (parity-tested at small
    sizes in ``tests/distributed/test_bdia_dist.py``); each diagonal
    block gets ``+4·dof`` on its main diagonal so CG-class solves are
    well conditioned.
    """
    ny = ny or nx
    nbr = nx * ny
    P = nshards
    nbloc = _ceil_div(nbr, P)
    offsets = tuple(sorted({-ny, -1, 0, 1, ny}))
    kept = np.asarray(offsets, dtype=np.int64)
    if np.abs(kept).max() > nbloc:
        raise ValueError(
            f"grid row length {ny} exceeds the {nbloc}-block shard — "
            "halo would be multi-hop; use partition_bdia for this shape")
    npairs = len(offsets) * dof

    g = np.arange(P * nbloc, dtype=np.int64)
    vals = np.zeros((dof, npairs, P * nbloc), dtype=dtype)
    for dpos, off in enumerate(offsets):
        ok = _fem_offset_mask(g, off, ny, nbr)
        for r in range(dof):
            for c in range(dof):
                v = _fem_formula_val(g, dpos, r, c, dof)
                if off == 0 and r == c:
                    v = v + 4.0 * dof
                vals[r, dpos * dof + c] = np.where(ok, v, 0.0)
    vals = np.ascontiguousarray(
        vals.reshape(dof, npairs, P, nbloc).transpose(2, 0, 1, 3))
    head_vals, tail_vals = _bdia_edge_windows(vals, kept, dof, nbloc)
    n = nbr * dof
    return BdiaPartition(
        vals=jax.numpy.asarray(vals),
        head_vals=jax.numpy.asarray(head_vals),
        tail_vals=jax.numpy.asarray(tail_vals),
        remainder=None,
        block_offsets=offsets,
        shape=(n, n),
        blocksize=(dof, dof),
        nshards=P,
        mloc=nbloc * dof,
        nbloc=nbloc,
    )


def fem_formula_bsr(nx: int, ny: Optional[int] = None, *, dof: int = 4,
                    dtype=np.float64):
    """The same matrix :func:`fem_bdia_partition` encodes, as a host BSR
    (the reference for the formulaic builders).  Built block-row-major
    straight from the formula — O(nnz) numpy, no sort — so it stays
    quick at millions of block rows."""
    from cask_tpu.formats.matrix import BSR

    ny = ny or nx
    nbr = nx * ny
    offsets = tuple(sorted({-ny, -1, 0, 1, ny}))
    g = np.arange(nbr, dtype=np.int64)
    present = np.stack([_fem_offset_mask(g, off, ny, nbr) for off in offsets],
                       axis=1)  # (nbr, 5): offsets ascending = columns sorted
    cols = g[:, None] + np.asarray(offsets)[None, :]
    blocks = np.empty((nbr, len(offsets), dof, dof), dtype=dtype)
    for dpos, off in enumerate(offsets):
        for r in range(dof):
            for c in range(dof):
                v = _fem_formula_val(g, dpos, r, c, dof)
                if off == 0 and r == c:
                    v = v + 4.0 * dof
                blocks[:, dpos, r, c] = v
    indptr = np.zeros(nbr + 1, dtype=np.int64)
    np.cumsum(present.sum(axis=1), out=indptr[1:])
    n = nbr * dof
    return BSR(data=blocks[present], indices=cols[present].astype(np.int32),
               indptr=indptr.astype(np.int32), shape=(n, n),
               blocksize=(dof, dof))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Coo2DPartition:
    """2-D block partition over a (rows, cols) mesh — SUMMA-style SpMV.

    Device (i, j) of a ``pr × pc`` mesh owns block ``A[i·mr:(i+1)·mr,
    j·mc:(j+1)·mc]`` as local COO.  x is sharded over the *cols* axis
    (each chip holds n/pc entries, vs the full gathered n of the 1-D
    plans), partial products ``A_ij @ x_j`` are summed with a ``psum``
    over the cols axis, and y lands sharded over the rows axis.  This is
    the scaling-book 2-D recipe: per-chip vector memory and collective
    payload shrink with the mesh's second dimension.
    """

    data: jax.Array  # (pr*pc, E)
    row: jax.Array  # (pr*pc, E) block-local row
    col: jax.Array  # (pr*pc, E) block-local col
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    pr: int = dataclasses.field(metadata=dict(static=True))
    pc: int = dataclasses.field(metadata=dict(static=True))
    mr: int = dataclasses.field(metadata=dict(static=True))
    mc: int = dataclasses.field(metadata=dict(static=True))

    def device_put(self, device=None) -> "Coo2DPartition":
        return jax.tree.map(lambda x: jax.device_put(x, device), self)


def partition_2d(a: CSR, pr: int, pc: int) -> Coo2DPartition:
    """Block-partition a CSR over a pr × pc device grid."""
    m, n = a.shape
    mr = _ceil_div(m, pr)
    mc = _ceil_div(n, pc)
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    bi = rows // mr
    bj = indices // mc

    groups_d, groups_r, groups_c = [], [], []
    for i in range(pr):
        for j in range(pc):
            sel = (bi == i) & (bj == j)
            groups_d.append(data[sel])
            groups_r.append(rows[sel] - i * mr)
            groups_c.append(indices[sel] - j * mc)
    E = max((g.shape[0] for g in groups_d), default=0) or 1
    P = pr * pc
    return Coo2DPartition(
        data=jax.numpy.asarray(_pad_rows(groups_d, P, E, 0.0, data.dtype)),
        row=jax.numpy.asarray(_pad_rows(groups_r, P, E)),
        col=jax.numpy.asarray(_pad_rows(groups_c, P, E)),
        shape=(m, n), pr=pr, pc=pc, mr=mr, mc=mc,
    )
