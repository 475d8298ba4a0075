"""Dense-slot update phase of a low-cardinality hash aggregate.

Counterpart of ``spark_rapids_tpu/exec/pallas_agg.py`` (the module keeps
its name so a reader finds it).  For a single integer key whose observed
domain fits 1024 slots, sorting every batch by its keys is wasted work:
keys map to dense slots (slot 0 for nulls, ``key - lo + 1`` for the rest)
and one pass reduces every aggregate plane per slot.  Slot order (null,
lo, lo+1, ...) is the sorted path's group order (nulls first, ascending),
so counts, integer sums and min/max are identical to it; float sums
accumulate in another order, but in one fixed order: on a given card the
kernel's float sums come out bit for bit the same on every call.

The reduction is ``dense_slot_reduce``: on a CUDA tensor it launches the
hand-written Hopper kernel (``csrc/dense_slot_reduce.cu``, which
replaces the TPU kernel ``_pallas_reduce``) or raises; on a CPU tensor it
runs ``dense_slot_reduce_reference``, the plain PyTorch version of the
same contract.

Not carried over from the TPU package: the one-time Mosaic probe and its
XLA fallback, and the f64-limb split of int64 sums (an int64 sum is one
int64 plane added with two's-complement wraparound, as Java does).
``supports`` and ``max_capacity`` still route exactly as the JAX package
does, so the same batches take the kernel in both.  Nothing here is
cached by capacity: ``prepare_launch`` sizes each launch (``launch_plan``,
``fsum_grid``) from the rows of the call in hand, so the half of a batch
that an out-of-memory split hands the kernel launches at its own,
smaller capacity.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar.dtypes import (
    BOOLEAN, DATE, INT64, STRING, TIMESTAMP, device_dtype,
)
from spark_rapids_tpu_torch.conf import PALLAS_AGG
from spark_rapids_tpu_torch.exprs import aggregates as agf
from spark_rapids_tpu_torch.exprs.base import ColVal, EvalContext

MAX_K = 1024          # largest dense key domain the kernel handles

_REDUCE = {"add": "sum", "min": "amin", "max": "amax"}
_OPS = {"add": 0, "min": 1, "max": 2}
_KINDS = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
          torch.float64: 3}
_SMEM_BUDGET = 232448  # bytes of shared memory one Hopper block may use
_SMEM_PER_SM = 233472  # bytes of shared memory one SM holds for its blocks
_SMEM_PER_BLOCK = 1024  # of which the card keeps this much for each block
_MAX_PLANES = 32       # DSR_MAX_PLANES in the CUDA source
_ROWS = 8              # DSR_ROWS: rows a thread takes from each tile
_THREADS = 1024        # threads a block
_BLOCKS_PER_SM = 1
_FS_TILE = 16 * 512    # FS_ROWS * FS_THREADS: rows a block of the
                       # fixed-order float-add pass takes at a time


def neutral(op: str, dtype: torch.dtype):
    """The identity of add/min/max for values of ``dtype``."""
    if op == "add":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def dense_slot_reduce_reference(gid: torch.Tensor,
                                planes: Sequence[torch.Tensor],
                                ops: Sequence[str], K: int
                                ) -> List[torch.Tensor]:
    """Plain PyTorch version of the kernel: one ``scatter_reduce_`` per
    plane into a (K,) output that starts at the op's neutral.  Rows whose
    gid lies outside [0, K) are ignored, as in the kernel (and as the JAX
    package's one-hot kernel and ``segment_*`` ops drop them)."""
    idx = gid.to(torch.int64)
    inside = (idx >= 0) & (idx < K)
    idx = torch.where(inside, idx, torch.zeros_like(idx))
    outs = []
    for p, op in zip(planes, ops):
        fill = neutral(op, p.dtype)
        out = torch.full((K,), fill, dtype=p.dtype, device=p.device)
        out.scatter_reduce_(0, idx, torch.where(inside, p,
                                                torch.full_like(p, fill)),
                            reduce=_REDUCE[op], include_self=True)
        outs.append(out)
    return outs


def _plane_bytes(itemsize: int, K: int) -> int:
    """Shared memory of one plane's accumulators: K slots, 16-byte
    aligned, as the CUDA source lays them out."""
    return (K * itemsize + 15) // 16 * 16


def _groups_by_size(itemsizes: Sequence[int], K: int) -> List[List[int]]:
    groups: List[List[int]] = [[]]
    used = 0
    for j, size in enumerate(itemsizes):
        need = _plane_bytes(size, K)
        if groups[-1] and (used + need > _SMEM_BUDGET
                           or len(groups[-1]) == _MAX_PLANES):
            groups.append([])
            used = 0
        groups[-1].append(j)
        used += need
    return groups


def _plane_groups(planes: Sequence[torch.Tensor], K: int) -> List[List[int]]:
    """Split the planes, in order, into groups whose shared-memory
    accumulators (K slots each, 16-byte aligned) fit one block."""
    return _groups_by_size([p.element_size() for p in planes], K)


@dataclass(frozen=True)
class LaunchPlan:
    """One kernel launch: a plane group and its grid."""
    planes: Tuple[int, ...]  # indices into the spec's planes
    smem: int                # bytes of shared memory a block
    threads: int             # threads a block
    tile: int                # rows a block takes at a time
    grid: int                # blocks


def launch_plan(itemsizes: Sequence[int], K: int, n: int, sms: int, *,
                threads: int = _THREADS, blocks_per_sm: int = _BLOCKS_PER_SM
                ) -> List[LaunchPlan]:
    """The launches of a spec of planes of ``itemsizes`` bytes, ``n`` rows,
    on a card of ``sms`` SMs: one a plane group.  A group's grid is one
    wave: ``blocks_per_sm`` blocks an SM, fewer when the accumulators
    leave room for fewer, and never more blocks than tiles."""
    tile = _ROWS * threads
    tiles = max(1, -(-n // tile))
    plans = []
    for group in _groups_by_size(itemsizes, K):
        smem = sum(_plane_bytes(itemsizes[j], K) for j in group)
        per_sm = max(1, min(blocks_per_sm, 2048 // threads,
                            _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK)))
        plans.append(LaunchPlan(tuple(group), smem, threads, tile,
                                min(tiles, sms * per_sm)))
    return plans


def fsum_grid(n: int, sms: int) -> int:
    """Blocks of the float adds' fixed-order pass over ``n`` rows on a
    card of ``sms`` SMs: one an SM, never more than its tiles.  The grid
    fixes the order of the sums, so it depends on nothing else."""
    return min(max(1, -(-n // _FS_TILE)), sms)


def _check(gid: torch.Tensor, planes: Sequence[torch.Tensor],
           ops: Sequence[str], K: int) -> None:
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise TypeError(f"gid must be a 1-D int32 tensor, got {gid.dtype} "
                        f"of shape {tuple(gid.shape)}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K must be in [1, {MAX_K}], got {K}")
    if len(planes) != len(ops) or not planes:
        raise ValueError("need one op per plane and at least one plane")
    for p, op in zip(planes, ops):
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}")
        if p.dtype not in _KINDS:
            raise TypeError(f"plane dtype {p.dtype} is not int32, int64, "
                            "float32 or float64")
        if p.shape != gid.shape or p.device != gid.device:
            raise ValueError("every plane must match gid's shape and device")
    if not all(t.is_contiguous() for t in (gid, *planes)):
        raise ValueError("gid and the planes must be contiguous")


def _declare(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_slot_reduce.argtypes = [
        vp, ctypes.c_longlong, i, i, vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.dense_slot_reduce.restype = i
    lib.dense_slot_reduce_error.argtypes = [i]
    lib.dense_slot_reduce_error.restype = ctypes.c_char_p


def _kernel() -> ctypes.CDLL:
    return native.load("dense_slot_reduce", _declare)


def prepare_launch(gid: torch.Tensor, planes: Sequence[torch.Tensor],
                   ops: Sequence[str], K: int, **shape
                   ) -> Tuple[Callable[[], None], List[torch.Tensor]]:
    """The wrapper's host work for CUDA tensors: checks, outputs and the C
    arguments of every plane group -> ``(launch, outs)``.  ``launch()``
    runs the kernel on the current stream, one call per plane group, and
    fills ``outs``; it may be called again on the same inputs.  ``shape``
    (``threads``, ``blocks_per_sm``) overrides ``launch_plan``'s defaults,
    to measure them."""
    _check(gid, planes, ops, K)
    if gid.device.type != "cuda":
        raise RuntimeError(f"dense_slot_reduce: no kernel for "
                           f"{gid.device.type} tensors")
    lib = _kernel()
    dev = gid.device
    n = gid.numel()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    aligned = all(t.data_ptr() % 16 == 0 for t in (gid, *planes))
    plans = launch_plan([p.element_size() for p in planes], K, n, sms,
                        **shape)
    outs = [torch.empty(K, dtype=p.dtype, device=dev) for p in planes]
    fgrid = fsum_grid(n, sms)
    # a (fgrid, K) scratch of block partials for each float add
    parts = [torch.empty((fgrid, K), dtype=p.dtype, device=dev)
             if p.is_floating_point() and op == "add" else None
             for p, op in zip(planes, ops)]
    calls = []
    for plan in plans:
        ptrs = ctypes.c_void_p * len(plan.planes)
        ints = ctypes.c_int * len(plan.planes)
        arrays = (ptrs(*[planes[j].data_ptr() for j in plan.planes]),
                  ptrs(*[outs[j].data_ptr() for j in plan.planes]),
                  ints(*[_KINDS[planes[j].dtype] for j in plan.planes]),
                  ints(*[_OPS[ops[j]] for j in plan.planes]),
                  ptrs(*[None if parts[j] is None else parts[j].data_ptr()
                         for j in plan.planes]))
        # the arrays and the scratch ride along so that they outlive
        # every launch
        args = (gid.data_ptr(), n, K, len(plan.planes),
                *[ctypes.cast(a, ctypes.c_void_p) for a in arrays],
                int(aligned), plan.grid, plan.threads, fgrid)
        calls.append((args, (arrays, parts)))

    def launch() -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for args, _arrays in calls:
                rc = lib.dense_slot_reduce(*args, stream)
                if rc != 0:
                    msg = lib.dense_slot_reduce_error(rc).decode()
                    raise RuntimeError(f"dense_slot_reduce launch failed: "
                                       f"CUDA error {rc} ({msg})")
                native.count_launch("dense_slot_reduce")

    return launch, outs


def dense_slot_reduce(gid: torch.Tensor, planes: Sequence[torch.Tensor],
                      ops: Sequence[str], K: int) -> List[torch.Tensor]:
    """Per-slot add/min/max of each (capacity,) plane over the rows whose
    ``gid`` names the slot -> one (K,) tensor a plane; rows whose gid lies
    outside [0, K) are ignored.  CUDA tensors launch the Hopper kernel;
    CPU tensors run the plain version."""
    if gid.device.type == "cpu":
        _check(gid, planes, ops, K)
        return dense_slot_reduce_reference(gid, planes, ops, K)
    launch, outs = prepare_launch(gid, planes, ops, K)
    launch()
    return outs


# ---------------------------------------------------------------------------
# routing (same rules as the JAX package)
# ---------------------------------------------------------------------------

def enabled(conf) -> bool:
    return bool(conf.get(PALLAS_AGG))


def max_capacity(spec) -> int:
    """Largest batch capacity the JAX package's kernel stays exact at for
    this spec (its int64-sum limbs cap those at 2^21 rows).  The port
    has no limbs, but routes by the same bound so that both packages
    send the same batches to the dense-slot path."""
    for _, f in spec.aggs:
        if isinstance(f, (agf.Sum, agf.Average)):
            if not f.input_projection()[0].dtype.is_floating:
                return 1 << 21
    return 1 << 24


def supports(spec) -> bool:
    """Single integer-like group key; Count/Sum/Min/Max/Average over
    non-string, non-boolean inputs, and no 64-bit min/max (the JAX
    package keeps those on the sorted path)."""
    if len(spec.groupings) != 1:
        return False
    kdt = spec.groupings[0].dtype
    if kdt == STRING or kdt.is_floating:
        return False
    for _, f in spec.aggs:
        if not isinstance(f, (agf.Count, agf.Sum, agf.Min, agf.Max,
                              agf.Average)):
            return False
        proj = f.input_projection()[0]
        if proj.dtype in (STRING, BOOLEAN):
            return False
        if isinstance(f, (agf.Min, agf.Max)) and \
                proj.dtype in (INT64, TIMESTAMP):
            return False
    return True


def key_range(grouping, cols: Sequence[ColVal], num_rows: int,
              capacity: int) -> Optional[Tuple[int, int]]:
    """(min, max) of the valid keys in the batch, or None when no key is
    valid: one ``torch.aminmax`` and one host sync."""
    device = cols[0].data.device
    ctx = EvalContext(cols, num_rows, capacity, device)
    cv = grouping.emit(ctx)
    m = cv.validity & (torch.arange(capacity, device=device) < num_rows)
    v = cv.data.to(torch.int64)
    # fill invalid rows with the first valid key so that one aminmax over
    # all rows is the range of the valid ones
    first = torch.argmax(m.to(torch.uint8))
    lo, hi = torch.aminmax(torch.where(m, v, v[first]))
    lo, hi, any_valid = torch.stack(
        [lo, hi, m[first].to(torch.int64)]).tolist()
    if not any_valid:
        return None
    return lo, hi


def fits(lo: int, hi: int) -> bool:
    return hi - lo + 2 <= MAX_K  # +1 null slot


def slot_count(lo: int, hi: int) -> int:
    """K for keys in [lo, hi]: the null slot plus the span, rounded up to
    a power of two of at least 128."""
    k = 128
    while k < hi - lo + 2:
        k *= 2
    return k


def update_planes(spec, cols: Sequence[ColVal], num_rows: int,
                  capacity: int, lo: int, K: int):
    """The kernel's inputs for one update batch -> ``(gid, planes, ops,
    post)``: gid, one plane per update op (after the occupancy plane) and
    the post-processing that turns the reduced planes into buffers."""
    grouping = spec.groupings[0]
    device = cols[0].data.device
    ctx = EvalContext(cols, num_rows, capacity, device)
    live = torch.arange(capacity, device=device) < num_rows
    kcv = grouping.emit(ctx)
    kvalid = kcv.validity & live
    # int64 key - lo + 1, clipped to [0, K-1], then int32: that order
    gid = torch.where(kvalid, kcv.data.to(torch.int64) - lo + 1,
                      torch.zeros((), dtype=torch.int64, device=device))
    gid = gid.clamp(0, K - 1).to(torch.int32)

    planes: List[torch.Tensor] = [live.to(torch.int32)]  # occupancy
    ops: List[str] = ["add"]
    post: List[tuple] = []  # (kind, plane indices..., cast dtype)
    for _, f in spec.aggs:
        cv = f.input_projection()[0].emit(ctx)
        m = cv.validity & live
        for op in f.update_ops():
            if op == "count":
                planes.append(m.to(torch.int32))
                ops.append("add")
                post.append(("cast", len(planes) - 1, torch.int64))
            elif op == "sum":
                # a float sum adds in its own type; an integral sum is
                # one int64 plane (Sum's projection casts to long)
                planes.append(torch.where(m, cv.data,
                                          torch.zeros_like(cv.data)))
                ops.append("add")
                post.append(("plain", len(planes) - 1))
            elif cv.data.dtype.is_floating_point:
                # Spark NaN order: min ignores NaN unless all-NaN;
                # max is NaN when any value is
                nan = torch.isnan(cv.data)
                planes.append(torch.where(
                    m & ~nan, cv.data,
                    torch.full_like(cv.data, neutral(op, cv.data.dtype))))
                ops.append(op)
                i_val = len(planes) - 1
                planes.append((m & nan).to(torch.int32))
                ops.append("max")
                planes.append((m & ~nan).to(torch.int32))
                ops.append("max")
                post.append(("nan" + op, i_val, len(planes) - 2,
                             len(planes) - 1))
            else:
                # int8/16/32/date reduce in int32; the neutral is the
                # NARROW type's extreme, widened, so an empty group's
                # sentinel survives the cast back and still loses
                # every merge
                v32 = cv.data.to(torch.int32)
                planes.append(torch.where(
                    m, v32, torch.full_like(v32, neutral(op, cv.data.dtype))))
                ops.append(op)
                post.append(("cast", len(planes) - 1, cv.data.dtype))
    return gid, planes, ops, post


def make_update(spec, capacity: int, lo_hint: int, hi_hint: int):
    """``(cols, num_rows, lo) -> (n_groups, keys, buffers)`` matching the
    sorted path's update contract (same group order).  K is derived here,
    the one owner of the null-slot layout."""
    K = slot_count(lo_hint, hi_hint)
    kdt = spec.groupings[0].dtype

    def run(cols: Sequence[ColVal], num_rows: int, lo: int):
        device = cols[0].data.device
        gid, planes, ops, post = update_planes(spec, cols, num_rows,
                                               capacity, lo, K)
        reds = dense_slot_reduce(gid, planes, ops, K)

        seen = reds[0] > 0
        n_groups = int(seen.sum())
        # compact occupied slots to the front; slot order is already the
        # sorted path's nulls-first ascending group order
        perm = torch.sort((~seen).to(torch.int8), stable=True).indices
        pos = torch.arange(K, device=device)
        group_valid = pos < n_groups

        kd = lo - 1 + torch.arange(K, dtype=torch.int64, device=device)
        if kdt == BOOLEAN:
            kd = kd.to(torch.bool)
        elif kdt == DATE:
            kd = kd.to(torch.int32)
        else:
            kd = kd.to(device_dtype(kdt))
        key_out = ColVal(kd[perm], group_valid & (perm != 0))

        buf_outs = []
        for item in post:
            if item[0] == "plain":
                buf_outs.append(ColVal(reds[item[1]][perm], group_valid))
            elif item[0] == "cast":
                buf_outs.append(ColVal(reds[item[1]][perm].to(item[2]),
                                       group_valid))
            else:
                base = reds[item[1]][perm]
                has_nan = reds[item[2]][perm] > 0
                has_non = reds[item[3]][perm] > 0
                nan_v = torch.full_like(base, float("nan"))
                if item[0] == "nanmin":
                    out = torch.where(has_nan & ~has_non, nan_v, base)
                else:
                    out = torch.where(has_nan, nan_v, base)
                buf_outs.append(ColVal(out, group_valid))
        return n_groups, (key_out,), tuple(buf_outs)

    return run
