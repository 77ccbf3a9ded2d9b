"""Multi-chip SpMV/SpMM execution over a device mesh (BASELINE T7/T8).

The comm backend is XLA collectives, which XLA hands to NCCL on GPUs
(SURVEY.md §5), so the work here is partitioning, halo minimization, and
*overlap*: every kernel is
written so the bulk of the local compute has no data dependence on the
collective's result, letting the XLA scheduler run the `ppermute` /
`all_gather` DMA concurrently with the interior FMAs:

    y_interior = f(local values, local x)      # big, collective-free
    halo       = ppermute(edge slices)         # in flight meanwhile
    y          = y_interior + fixup(halo)      # tiny edge correction

Verified overlap is a bench-time obligation (SURVEY.md §7 hard-part (d));
the structure here is what makes it *possible*.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cask_tpu.parallel.partition import BdiaPartition, CooPartition, DiaPartition

AXIS = "shards"


def row_mesh(nshards: Optional[int] = None, *, devices=None) -> Mesh:
    """1-D mesh over the row-partition axis.

    Axis type Auto: solvers run unmodified on sharded vectors (dots
    become psums via GSPMD propagation) without explicit out_sharding
    annotations at every contraction."""
    devices = devices if devices is not None else jax.devices()
    nshards = nshards or len(devices)
    return jax.make_mesh(
        (nshards,), (AXIS,), devices=devices[:nshards],
        axis_types=(jax.sharding.AxisType.Auto,),
    )


# ---------------------------------------------------------------------------
# per-shard compute bodies (run inside shard_map; leading shard axis == 1)
# ---------------------------------------------------------------------------


def _sq(x):
    return x.reshape(x.shape[1:])


def _coo_local(plan: CooPartition, x_loc, axis: str):
    """Interior/exterior split: interior is independent of the gather."""
    int_data, int_row, int_col = _sq(plan.int_data), _sq(plan.int_row), _sq(plan.int_col)
    ext_data, ext_row, ext_col = _sq(plan.ext_data), _sq(plan.ext_row), _sq(plan.ext_col)
    xg = jax.lax.all_gather(x_loc, axis, tiled=True)  # (P*mloc,) — async vs interior
    y = jax.ops.segment_sum(int_data * x_loc[int_col], int_row, num_segments=plan.mloc)
    y = y + jax.ops.segment_sum(ext_data * xg[ext_col], ext_row, num_segments=plan.mloc)
    return y


def _coo_local_mm(plan: CooPartition, x_loc, axis: str):
    int_data, int_row, int_col = _sq(plan.int_data), _sq(plan.int_row), _sq(plan.int_col)
    ext_data, ext_row, ext_col = _sq(plan.ext_data), _sq(plan.ext_row), _sq(plan.ext_col)
    xg = jax.lax.all_gather(x_loc, axis, tiled=True)  # (P*mloc, k)
    y = jax.ops.segment_sum(int_data[:, None] * x_loc[int_col], int_row, num_segments=plan.mloc)
    y = y + jax.ops.segment_sum(ext_data[:, None] * xg[ext_col], ext_row, num_segments=plan.mloc)
    return y


def _ring_halo(x_loc, lo: int, hi: int, axis: str, nshards: int):
    """Exchange edge slices with ring neighbors.

    left[j]  = x of global row (base - lo + j)   (from shard p-1)
    right[j] = x of global row (base + mloc + j) (from shard p+1)

    Wraparound shards receive garbage, but every matrix value referring
    past the global edge is a structural zero, so the product vanishes.
    """
    fwd = [(p, (p + 1) % nshards) for p in range(nshards)]
    bwd = [(p, (p - 1) % nshards) for p in range(nshards)]
    left = jax.lax.ppermute(x_loc[-lo:] if lo else x_loc[:0], axis, fwd) if lo else None
    right = jax.lax.ppermute(x_loc[:hi] if hi else x_loc[:0], axis, bwd) if hi else None
    return left, right


def _dia_local(plan: DiaPartition, x_loc, axis: str, overlap: bool = True):
    vals = _sq(plan.vals)  # (D, mloc)
    mloc = plan.mloc
    lo, hi = plan.halo_lo, plan.halo_hi

    # 1. start the ring exchange (and the remainder's all_gather)
    left, right = _ring_halo(x_loc, lo, hi, axis, plan.nshards)
    y_rem = _coo_local(plan.remainder, x_loc, axis) if plan.remainder is not None else None

    if not overlap:
        # A/B instrumentation (SURVEY §7 hard-part (d)): force the
        # interior to wait for the collectives — the measured difference
        # vs overlap=True is the comm time actually hidden.
        deps = tuple(v for v in (x_loc, left, right) if v is not None)
        out = jax.lax.optimization_barrier(deps)
        x_loc = out[0]
        it = iter(out[1:])
        left = next(it) if left is not None else None
        right = next(it) if right is not None else None

    # 2. interior: shifted FMAs against zero-padded local x — no halo dep
    xp = jnp.zeros(lo + mloc + hi, x_loc.dtype).at[lo : lo + mloc].set(x_loc)
    y = jnp.zeros(mloc, dtype=jnp.result_type(vals.dtype, x_loc.dtype))
    for d, off in enumerate(plan.offsets):
        y = y + vals[d] * jax.lax.dynamic_slice(xp, (lo + off,), (mloc,))

    # 3. tiny edge fix-ups once the halo lands
    for d, off in enumerate(plan.offsets):
        if off < 0 and lo:
            w = -off
            y = y.at[:w].add(vals[d, :w] * jax.lax.dynamic_slice(left, (lo + off,), (w,)))
        elif off > 0 and hi:
            w = off
            y = y.at[mloc - w :].add(vals[d, mloc - w :] * right[:w])
    if y_rem is not None:
        y = y + y_rem
    return y


def _dia_local_mm(plan: DiaPartition, x_loc, axis: str):
    vals = _sq(plan.vals)
    mloc = plan.mloc
    lo, hi = plan.halo_lo, plan.halo_hi
    k = x_loc.shape[1]

    left, right = _ring_halo(x_loc, lo, hi, axis, plan.nshards)
    y_rem = _coo_local_mm(plan.remainder, x_loc, axis) if plan.remainder is not None else None

    xp = jnp.zeros((lo + mloc + hi, k), x_loc.dtype).at[lo : lo + mloc].set(x_loc)
    y = jnp.zeros((mloc, k), dtype=jnp.result_type(vals.dtype, x_loc.dtype))
    for d, off in enumerate(plan.offsets):
        xs = jax.lax.dynamic_slice(xp, (lo + off, 0), (mloc, k))
        y = y + vals[d][:, None] * xs

    for d, off in enumerate(plan.offsets):
        if off < 0 and lo:
            w = -off
            y = y.at[:w].add(
                vals[d, :w, None] * jax.lax.dynamic_slice(left, (lo + off, 0), (w, k))
            )
        elif off > 0 and hi:
            w = off
            y = y.at[mloc - w :].add(vals[d, mloc - w :, None] * right[:w])
    if y_rem is not None:
        y = y + y_rem
    return y


def _bdia_shard_matrix(plan: BdiaPartition):
    """This shard's local (mloc × mloc) BdiaMatrix view (no remainder —
    that rides the embedded CooPartition)."""
    from cask_tpu.ops.bdia import BdiaMatrix

    vals = _sq(plan.vals)  # (br, npairs, nbloc)
    return BdiaMatrix(
        vals=vals,
        rem_data=jnp.zeros((0,), vals.dtype),
        rem_row=jnp.zeros((0,), jnp.int32),
        rem_col=jnp.zeros((0,), jnp.int32),
        block_offsets=plan.block_offsets,
        shape=(plan.mloc, plan.mloc),
        blocksize=plan.blocksize,
    )


def _bdia_edge_fixups(plan: BdiaPartition, left, right, *, k: int = 0):
    """Component-plane halo corrections (head, tail) as natural-order
    deltas of the first lo_b·br / last hi_b·br scalar rows.

    ``head_vals``/``tail_vals`` are zero wherever the term was already
    covered by the zero-padded interior, so each pair's window FMA adds
    exactly the out-of-shard contributions (same discipline as
    ``_dia_local``'s per-offset edge adds, lifted to block components).
    """
    br, bc = plan.blocksize
    lo_b, hi_b = plan.halo_lo_b, plan.halo_hi_b
    hv, tv = _sq(plan.head_vals), _sq(plan.tail_vals)  # (br, npairs, w)
    head_nat = tail_nat = None
    if lo_b and left is not None:
        acc_t = jnp.result_type(hv.dtype, left.dtype)
        # left: (lo_b*bc,) or (lo_b*bc, k) natural order → (bc, lo_b[, k])
        lp = left.reshape((lo_b, bc) + left.shape[1:])
        lp = jnp.moveaxis(lp, 1, 0)
        pad = [(0, 0)] * lp.ndim
        pad[1] = (0, lo_b)
        lpad = jnp.pad(lp, pad)  # reads past the valid span hit zeroed vals
        head = jnp.zeros((br, lo_b) + left.shape[1:], dtype=acc_t)
        for j, (c, d) in enumerate(plan.pairs):
            if d >= 0:
                continue
            start = (c, lo_b + d) + (0,) * (lp.ndim - 2)
            xs = jax.lax.dynamic_slice(
                lpad, start, (1, lo_b) + lpad.shape[2:])[0]
            w = hv[:, j, :, None] if k else hv[:, j, :]
            head = head + w * xs
        head_nat = jnp.moveaxis(head, 0, 1).reshape((lo_b * br,) + left.shape[1:])
    if hi_b and right is not None:
        acc_t = jnp.result_type(tv.dtype, right.dtype)
        rp = right.reshape((hi_b, bc) + right.shape[1:])
        rp = jnp.moveaxis(rp, 1, 0)
        pad = [(0, 0)] * rp.ndim
        pad[1] = (hi_b, 0)
        rpad = jnp.pad(rp, pad)
        tail = jnp.zeros((br, hi_b) + right.shape[1:], dtype=acc_t)
        for j, (c, d) in enumerate(plan.pairs):
            if d <= 0:
                continue
            start = (c, d) + (0,) * (rp.ndim - 2)
            xs = jax.lax.dynamic_slice(
                rpad, start, (1, hi_b) + rpad.shape[2:])[0]
            w = tv[:, j, :, None] if k else tv[:, j, :]
            tail = tail + w * xs
        tail_nat = jnp.moveaxis(tail, 0, 1).reshape((hi_b * br,) + right.shape[1:])
    return head_nat, tail_nat


def _bdia_local(plan: BdiaPartition, x_loc, axis: str, overlap: bool = True):
    """Per-shard BDIA SpMV: ring halo + collective-free interior + edge
    fixups — the tuned-BSR block path at config-5 scale."""
    br, bc = plan.blocksize
    lo, hi = plan.halo_lo_b * bc, plan.halo_hi_b * bc

    # 1. collectives depart first
    left, right = _ring_halo(x_loc, lo, hi, axis, plan.nshards)
    y_rem = _coo_local(plan.remainder, x_loc, axis) if plan.remainder is not None else None

    if not overlap:
        deps = tuple(v for v in (x_loc, left, right) if v is not None)
        out = jax.lax.optimization_barrier(deps)
        x_loc = out[0]
        it = iter(out[1:])
        left = next(it) if left is not None else None
        right = next(it) if right is not None else None

    # 2. interior on zero-padded local x (structural-zero discipline:
    #    pairs reaching past the shard read pad zeros — no halo dep).
    #    The XLA formulation: its outputs carry shard_map's varying-axes
    #    types, which a pallas_call's do not
    y = _bdia_shard_matrix(plan)._xla(x_loc)

    # 3. edge fixups once the halo lands
    head, tail = _bdia_edge_fixups(plan, left, right)
    if head is not None:
        y = y.at[: head.shape[0]].add(head.astype(y.dtype))
    if tail is not None:
        y = y.at[plan.mloc - tail.shape[0] :].add(tail.astype(y.dtype))
    if y_rem is not None:
        y = y + y_rem
    return y


def _bdia_local_mm(plan: BdiaPartition, x_loc, axis: str):
    br, bc = plan.blocksize
    lo, hi = plan.halo_lo_b * bc, plan.halo_hi_b * bc
    k = x_loc.shape[1]

    left, right = _ring_halo(x_loc, lo, hi, axis, plan.nshards)
    y_rem = _coo_local_mm(plan.remainder, x_loc, axis) if plan.remainder is not None else None

    # interior: component-split shifted slices, one (c, d) pair at a time
    y = _bdia_shard_matrix(plan)._xla(x_loc)

    head, tail = _bdia_edge_fixups(plan, left, right, k=k)
    if head is not None:
        y = y.at[: head.shape[0]].add(head.astype(y.dtype))
    if tail is not None:
        y = y.at[plan.mloc - tail.shape[0] :].add(tail.astype(y.dtype))
    if y_rem is not None:
        y = y + y_rem
    return y


# ---------------------------------------------------------------------------
# user-facing executor
# ---------------------------------------------------------------------------


class DistSpmv:
    """A partitioned matrix bound to a mesh; callable on global vectors.

    ``DistSpmv(plan, mesh)(x)`` accepts a global ``x`` (host or device,
    any sharding), returns the global ``y`` sharded over the mesh.  For
    device-resident iteration (solvers), use :meth:`padded` + the
    returned sharded arrays so no host round-trips occur.
    """

    def __init__(self, plan, mesh: Optional[Mesh] = None, *, overlap: bool = True):
        self.plan = plan
        self.mesh = mesh if mesh is not None else row_mesh(plan.nshards)
        if self.mesh.shape[AXIS] != plan.nshards:
            raise ValueError(
                f"plan has {plan.nshards} shards but mesh axis '{AXIS}' "
                f"has {self.mesh.shape[AXIS]} devices"
            )
        self._xsharding = NamedSharding(self.mesh, P(AXIS))
        if isinstance(plan, DiaPartition):
            local = partial(_dia_local, overlap=overlap)
            local_mm = _dia_local_mm
        elif isinstance(plan, BdiaPartition):
            local = partial(_bdia_local, overlap=overlap)
            local_mm = _bdia_local_mm
        else:
            local = _coo_local
            local_mm = _coo_local_mm

        plan_specs = jax.tree.map(lambda _: P(AXIS), plan)
        self.plan_dev = jax.device_put(
            plan, jax.tree.map(lambda s: NamedSharding(self.mesh, s), plan_specs)
        )

        self._spmv = jax.jit(
            shard_map(
                partial(local, axis=AXIS),
                mesh=self.mesh,
                in_specs=(plan_specs, P(AXIS)),
                out_specs=P(AXIS),
            )
        )
        self._spmm = jax.jit(
            shard_map(
                partial(local_mm, axis=AXIS),
                mesh=self.mesh,
                in_specs=(plan_specs, P(AXIS, None)),
                out_specs=P(AXIS, None),
            )
        )

    @property
    def padded_n(self) -> int:
        return self.plan.nshards * self.plan.mloc

    def padded(self, x):
        """Pad a global vector/matrix to P*mloc rows and shard it."""
        x = jnp.asarray(x)
        pad = self.padded_n - x.shape[0]
        xp = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
        if x.ndim == 1:
            return jax.device_put(xp, self._xsharding)
        return jax.device_put(xp, NamedSharding(self.mesh, P(AXIS, None)))

    def _unpad(self, y):
        m = self.plan.shape[0]
        if y.shape[0] == m:
            return y
        # XLA can't express a slice of a sharded dim when m doesn't
        # divide the mesh, so the convenience path replicates first;
        # scale users keep padded shapes via `padded_op`.  Replicating
        # a config-5-sized y onto every device is an OOM foot-gun —
        # warn loudly once.
        if y.size * jnp.dtype(y.dtype).itemsize > 64 * 1024 * 1024:
            import warnings

            warnings.warn(
                f"DistSpmv convenience path replicates the full "
                f"{y.size * jnp.dtype(y.dtype).itemsize / 2**20:.0f} MB "
                "result on every device to slice off row padding; at this "
                "scale use `padded_op` with padded shapes (or a row count "
                "divisible by the mesh) to stay sharded.",
                RuntimeWarning, stacklevel=3)
        y = jax.device_put(y, NamedSharding(self.mesh, P()))
        return y[:m]

    def __call__(self, x):
        x = jnp.asarray(x)
        if x.ndim == 1:
            return self._unpad(self._spmv(self.plan_dev, self.padded(x)))
        return self._unpad(self._spmm(self.plan_dev, self.padded(x)))

    def padded_op(self, xp):
        """Operator on already-padded, sharded vectors (for solvers):
        keeps everything device-resident with zero reshard traffic.

        NOTE: inside a USER jit this closes over the plan as compile-time
        constants — fine at small scale, but large plans make compiles
        slow.  Jitted solver loops should thread :attr:`operands` through
        as arguments and call :meth:`padded_op_with`."""
        return self.padded_op_with(self.operands, xp)

    @property
    def operands(self):
        """Device operand pytree to pass through jitted loops as
        ARGUMENTS via :meth:`padded_op_with`."""
        return (self.plan_dev,)

    def padded_op_with(self, ops, xp):
        """Like :meth:`padded_op`, but with :attr:`operands` supplied
        explicitly (traced) — use inside jitted solver loops."""
        if xp.ndim == 1:
            return self._spmv(ops[0], xp)
        return self._spmm(ops[0], xp)


# ---------------------------------------------------------------------------
# 2-D (SUMMA-style) executor
# ---------------------------------------------------------------------------

ROW_AXIS = "rows2d"
COL_AXIS = "cols2d"


def mesh_2d(pr: int, pc: int, *, devices=None) -> Mesh:
    """A (rows, cols) mesh for :class:`Dist2DSpmv`."""
    import numpy as _np

    devices = devices if devices is not None else jax.devices()
    if len(devices) < pr * pc:
        raise ValueError(f"need {pr * pc} devices, have {len(devices)}")
    return Mesh(_np.asarray(devices[: pr * pc]).reshape(pr, pc),
                (ROW_AXIS, COL_AXIS))


def _local_2d(plan, x_loc):
    """Partial block product on one device; caller psums over cols."""
    data, row, col = _sq(plan.data), _sq(plan.row), _sq(plan.col)
    if x_loc.ndim == 1:
        prod = data * x_loc[col]
    else:
        prod = data[:, None] * x_loc[col]
    part = jax.ops.segment_sum(prod, row, num_segments=plan.mr)
    return jax.lax.psum(part, COL_AXIS)


class Dist2DSpmv:
    """2-D block-partitioned SpMV/SpMM over a (rows, cols) mesh.

    Per-chip x footprint is n/pc (vs the 1-D plans' all-gathered n) and
    the only collective is a cols-axis ``psum`` of y partials — the 2-D
    point of the scaling-book recipe.  y returns sharded over rows.
    """

    def __init__(self, plan: "Coo2DPartition", mesh: Optional[Mesh] = None):
        from cask_tpu.parallel.partition import Coo2DPartition

        assert isinstance(plan, Coo2DPartition)
        self.plan = plan
        self.mesh = mesh if mesh is not None else mesh_2d(plan.pr, plan.pc)
        if (self.mesh.shape[ROW_AXIS], self.mesh.shape[COL_AXIS]) != (plan.pr, plan.pc):
            raise ValueError("mesh shape does not match the plan's pr × pc")
        plan_specs = jax.tree.map(lambda _: P((ROW_AXIS, COL_AXIS)), plan)
        self._spmv = jax.jit(shard_map(
            lambda pl_, x: _local_2d(pl_, x),
            mesh=self.mesh,
            in_specs=(plan_specs, P(COL_AXIS)),
            out_specs=P(ROW_AXIS),
            check_vma=False,
        ))
        self._spmm = jax.jit(shard_map(
            lambda pl_, x: _local_2d(pl_, x),
            mesh=self.mesh,
            in_specs=(plan_specs, P(COL_AXIS, None)),
            out_specs=P(ROW_AXIS, None),
            check_vma=False,
        ))
        self.plan_dev = jax.device_put(
            plan, jax.tree.map(lambda s: NamedSharding(self.mesh, s), plan_specs))

    def padded_x(self, x):
        x = jnp.asarray(x)
        pad = self.plan.pc * self.plan.mc - x.shape[0]
        xp = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
        spec = P(COL_AXIS) if x.ndim == 1 else P(COL_AXIS, None)
        return jax.device_put(xp, NamedSharding(self.mesh, spec))

    @property
    def square_padded(self) -> bool:
        return self.plan.pr * self.plan.mr == self.plan.pc * self.plan.mc

    def padded_op(self, xp):
        """Operator on already-padded vectors for solver loops: y is
        resharded back to x's cols-axis layout (one cross-axis reshard —
        the 2-D analog of the 1-D plans' zero-reshard ``padded_op``), so
        Krylov iterations compose without host round-trips.  Needs the
        padded operator square (pr·mr == pc·mc)."""
        if not self.square_padded:
            raise ValueError(
                "padded_op needs pr*mr == pc*mc (square padded operator); "
                f"got {self.plan.pr}x{self.plan.mr} vs {self.plan.pc}x{self.plan.mc}")
        y = self._spmv(self.plan_dev, xp) if xp.ndim == 1 else \
            self._spmm(self.plan_dev, xp)
        spec = P(COL_AXIS) if xp.ndim == 1 else P(COL_AXIS, None)
        return jax.device_put(y, NamedSharding(self.mesh, spec))

    def __call__(self, x):
        xp = self.padded_x(x)
        y = self._spmv(self.plan_dev, xp) if xp.ndim == 1 else \
            self._spmm(self.plan_dev, xp)
        m = self.plan.shape[0]
        if y.size * jnp.dtype(y.dtype).itemsize > 64 * 1024 * 1024:
            # mirror of the 1-D convenience-path guard
            import warnings

            warnings.warn(
                f"Dist2DSpmv convenience path replicates the full "
                f"{y.size * jnp.dtype(y.dtype).itemsize / 2**20:.0f} MB "
                "result on every device to slice off row padding; at this "
                "scale use `padded_op` with padded shapes to stay sharded.",
                RuntimeWarning, stacklevel=2)
        y = jax.device_put(y, NamedSharding(self.mesh, P()))
        return y[:m]
