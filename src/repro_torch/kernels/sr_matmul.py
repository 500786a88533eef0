"""sr_matmul: matmul with f32 accumulation, optional fused SR-bf16 cast.

Port of the TPU kernel ``repro/kernels/sr_matmul.py::sr_matmul``.  The
CUDA kernels are ``csrc/sr_matmul.cu`` and the mainloop it shares with
outer_accum, ``csrc/gemm_sm90.cuh`` (their headers say what bounds each
role on the H100 and how it is tiled); :func:`sr_matmul_plain` is the
plain torch version.  :func:`sr_matmul` runs the plain version for
tensors on the CPU and a kernel for tensors on a CUDA device — never one
in place of the other.  Operands are both bf16 (tensor cores) or both
f32 (the fp32 preset: f32 FMA on the CUDA cores, no TF32, through
``csrc/sgemm_sm90.cuh``).

bf16 operands take one of two paths, chosen by :func:`plan` from shapes
and strides alone: ``sm90`` (TMA + wgmma, deterministic split-K) for
every operand the TMA can describe, ``generic`` (WMMA) for the rest — a
base pointer that is not 16-byte aligned, or a row stride that is not a
multiple of 16 bytes.  f32 operands take the ``f32`` path, planned by
:func:`f32_plan` from (M, N, K) alone.  Each path has its own launch
counter.

:func:`sr_matmul_batched` is the kernel's batched mode, the TPU kernel
under ``jax.vmap`` (one ``pallas_call`` with an expert axis in its
grid): out[e] = a[e] @ b[e] for the E experts of a MoE table, f32 or
bf16 out, ONE launch a call, with each expert's (M, N, K) planned over
all E experts' tiles: bf16 operands on the sm90 path (:func:`plan`;
``csrc/gemm_sm90_batched.cuh``, which computes only each expert's live
rows when given their count), f32 operands (the fp32 preset) on the f32
path (:func:`f32_plan`; ``csrc/sgemm_sm90_batched.cuh``, likewise over
the live rows).  It has
its own counter (``sr_matmul:batched``) besides ``sr_matmul`` and the
path's; :func:`sr_matmul_batched_plain` is its plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.pmag import matmul_nest
from repro_torch.core.rounding import sr_cast_bf16
from repro_torch.kernels import build

COUNTER = build.LaunchCounter("sr_matmul")     # every launch, any path
PATHS = ("sm90", "generic", "f32")
PATH_COUNTERS = {p: build.LaunchCounter(f"sr_matmul:{p}") for p in PATHS}
BATCHED_COUNTER = build.LaunchCounter("sr_matmul:batched")
# the generic kernels' block tile (tm, tn, tk): csrc/common.cuh
TILE = (32, 32, 64)
# the sm90 mainloop's block rows and depth (csrc/gemm_sm90.cuh BM, BK)
SM90_BM, SM90_BK = 128, 64
# the split count fills up to this many SMs (the H100 SXM's 132) where
# the output tiles alone do not, with at least MIN_SPLIT_KB k-blocks a
# split; a product takes 64-wide tiles (twice the blocks) unless it has
# WIDE_N_TILES column tiles of 128 (rows_invariant; else SMS output
# tiles of 128 x 128), or enough k-blocks for split-K alone to fill the
# card at 128 wide
SMS = 132
MIN_SPLIT_KB = 16
WIDE_N_TILES = 16
# the f32 mainloop (csrc/sgemm_sm90.cuh): its block tile and the blocks
# an SM holds at once (its launch bounds); a split takes at least
# F32_MIN_SPLIT_KB k-blocks
F32_TILE = (128, 128, 16)
F32_OCC = 2
F32_MIN_SPLIT_KB = 8
# f32_plan's cost model: an SM's fma rate as this kernel reaches it
# (about 0.7 of the H100's 67 TFLOP/s over 132 SMs), the device memory
# rate that the split partials cross twice, and the rate at which one
# block sums them
F32_SM_FMA = 1.78e11
F32_HBM = 2.5e12
F32_BLOCK_BW = 1e11

class Plan(NamedTuple):
    """How one product runs: the path, its block tile and the number of
    splits of the reduction (blockIdx.z)."""
    path: str
    bm: int
    bn: int
    bk: int
    splits: int

    def kb_per_split(self, k: int) -> int:
        return math.ceil(math.ceil(k / self.bk) / self.splits)

    def k_ranges(self, k: int) -> list:
        """The [k0, k1) reduction range of each split, in order."""
        step = self.kb_per_split(k) * self.bk
        return [(s * step, min(k, (s + 1) * step))
                for s in range(self.splits)]

    def grid(self, m: int, n: int, k: int) -> tuple:
        """(x, y, z): the (i, j, l) counter bank over the plan's tiles —
        j and i become the grid's x and y, the splits its z."""
        nest = matmul_nest(m, n, k, tm=self.bm, tn=self.bn, tk=self.bk)
        return (*nest.launch_grid("j", "i"), self.splits)


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, a_major: str = "k", b_major: str = "n",
         *, lda: Optional[int] = None, ldb: Optional[int] = None,
         aligned: bool = True, rows_invariant: bool = True,
         f32: bool = False, experts: int = 1) -> Plan:
    """The plan of out(m, n) = A(m, k) . B(k, n): f32 operands take
    :func:`f32_plan`, bf16 operands the sm90 or the generic path.

    a_major: "k" (A stored (m, k)) or "m" (A = X^T, X stored (k, m));
    b_major: "n" (B stored (k, n)) or "k" (B stored (n, k)).  lda / ldb
    are the stored row strides in elements (default: contiguous), and
    `aligned` says both base pointers are 16-byte aligned.  The sm90
    path takes every operand the TMA can describe; the rest take the
    generic path.  With rows_invariant the split count depends on
    (n, k, layout) only, never on m, so a row's result does not depend
    on how many rows share the call (the engine's chunked PREFILL relies
    on that); without it (outer_accum, whose m is a weight dimension)
    the m tiles count towards filling the card too.  `experts` > 1 plans
    one expert's product of :func:`sr_matmul_batched`: the column tiles
    of every expert count towards filling the card (granite's tables
    take 128-wide tiles, which chip_smoke.py's [sr_matmul:experts] sweep
    measures faster than 64-wide ones, and than a split of K, warm and
    cold in L2, on the H100).
    """
    if a_major not in ("k", "m") or b_major not in ("k", "n"):
        raise ValueError(f"plan: majorness {a_major!r}, {b_major!r}")
    if f32:
        return f32_plan(m, n, k, experts=experts)
    lda = (k if a_major == "k" else m) if lda is None else lda
    ldb = (k if b_major == "k" else n) if ldb is None else ldb
    if not (aligned and lda % 8 == 0 and ldb % 8 == 0):
        return Plan("generic", *TILE, 1)
    k_blocks = max(1, math.ceil(k / SM90_BK))
    n128 = math.ceil(n / 128) * experts
    if rows_invariant:
        wide = (n128 >= WIDE_N_TILES
                or k_blocks // MIN_SPLIT_KB >= SMS // n128)
    else:
        wide = n128 * math.ceil(m / SM90_BM) >= SMS
    bn = 128 if wide else 64
    tiles = math.ceil(n / bn) * experts
    if not rows_invariant:
        tiles *= math.ceil(m / SM90_BM)
    splits = max(1, min(SMS // tiles, k_blocks // MIN_SPLIT_KB))
    per = math.ceil(k_blocks / splits)
    return Plan("sm90", SM90_BM, bn, SM90_BK, math.ceil(k_blocks / per))


@functools.lru_cache(maxsize=4096)
def f32_plan(m: int, n: int, k: int, experts: int = 1) -> Plan:
    """The plan of out(m, n) = A(m, k) . B(k, n) for f32 operands, from
    the shape alone (never majorness, strides or the device): the split
    count that a cost model of whole waves ranks fastest.  A wave holds
    SMS x F32_OCC blocks, and one that is not full costs as much as a
    full one, so a product whose tiles leave the card part-empty (the
    tied head's BP: 2 x 7 tiles) splits its reduction, paying the
    partials' round trip and their ordered sum.  `experts` plans one
    expert's product of a batched call, whose blocks are every expert's
    tiles (granite's tables at C = 1024: 32 tiles an expert, 1024
    blocks, no split; at C = 8, 128 blocks fill half a wave and K
    splits in two)."""
    bm, bn, bk = F32_TILE
    kb = max(1, math.ceil(k / bk))
    tiles = math.ceil(m / bm) * math.ceil(n / bn) * experts
    best = None
    for splits in range(1, kb + 1):
        per = math.ceil(kb / splits)
        if splits > 1 and per < F32_MIN_SPLIT_KB:
            break
        if math.ceil(kb / per) != splits:
            continue                           # the same as fewer splits
        waves = math.ceil(tiles * splits / (SMS * F32_OCC))
        t = waves * F32_OCC * bm * bn * per * bk / F32_SM_FMA
        if splits > 1:
            t += (2 * splits * experts * m * n * 4 / F32_HBM
                  + splits * bm * bn * 4 / F32_BLOCK_BW)
        if best is None or t < best[0]:
            best = (t, splits)
    return Plan("f32", bm, bn, bk, best[1])


def split_workspace(p: Plan, m: int, n: int, device,
                    experts: int = 1) -> Optional[torch.Tensor]:
    """The f32 path's split-K workspace, or None without splits: splits x
    experts x m x n f32 partials, then one int32 counter per output tile
    of each expert (zeroed: the last block of a tile to finish sees
    splits - 1)."""
    if p.splits <= 1:
        return None
    parts = p.splits * experts * m * n
    tiles = math.ceil(m / p.bm) * math.ceil(n / p.bn) * experts
    ws = torch.empty(parts + tiles, dtype=torch.float32, device=device)
    ws[parts:].view(torch.int32).zero_()
    return ws


def _ld(t: torch.Tensor) -> Optional[int]:
    """The row stride (elements) at which the bf16 paths read the 2-D
    `t` as it lies — unit inner stride, rows no closer than their length
    (a column slice of a wider matrix, say) — or None.  A one-row operand
    takes its row length rounded up to 8."""
    rows, cols = t.shape
    s0, s1 = t.stride()
    if cols > 1 and s1 != 1:
        return None
    if rows > 1:
        return s0 if s0 >= cols else None
    return max(8, -(-cols // 8) * 8)


def row_stride(t: torch.Tensor) -> int:
    """Elements between the rows of a 2-D operand as a kernel reads them."""
    ld = _ld(t)
    if ld is None:
        raise ValueError(f"no row stride for strides {t.stride()}")
    return ld


def takes_view(t: torch.Tensor) -> bool:
    """True when the bf16 paths read the 2-D `t` as it lies."""
    return t.dim() == 2 and _ld(t) is not None


def operand(t: torch.Tensor) -> torch.Tensor:
    """`t` itself where the sm90 path reads it as it lies (a bf16 view
    with 16-byte rows and base); a bf16 matrix with other rows (granite's
    49155-wide logits and their gradient) copied into rows padded to a
    multiple of 8 elements, as a view of its columns, so that the sm90
    path reads it too; anything else as a contiguous copy."""
    if t.dtype != torch.bfloat16 or not takes_view(t):
        return t.contiguous()
    if row_stride(t) % 8 == 0 and aligned16(t):
        return t
    rows, cols = t.shape
    padded = torch.empty((rows, -(-cols // 8) * 8), dtype=t.dtype,
                         device=t.device)
    view = padded[:, :cols]
    view.copy_(t)
    return view


def aligned16(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


@functools.lru_cache(maxsize=None)
def _bind(lib: ctypes.CDLL, name: str):
    """The C entry point `name`, without argtypes: every pointer is passed
    as a ctypes.c_void_p (build.ptr) or None, every int as a Python int
    (C int), which costs ctypes a third of the argtypes conversion on a
    call that the host's time bounds."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    return fn


def _shapes(a: torch.Tensor, b: torch.Tensor, trans_b: bool) -> tuple:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"sr_matmul takes 2-D operands, got {tuple(a.shape)}"
                         f" and {tuple(b.shape)}")
    m, k = a.shape
    n, k2 = (b.shape if trans_b else (b.shape[1], b.shape[0]))
    if k != k2:
        raise ValueError(f"sr_matmul: inner dims differ: {tuple(a.shape)} x "
                         f"{tuple(b.shape)} (trans_b={trans_b})")
    return m, n, k


def launch_error(name: str, err: int) -> RuntimeError:
    what = {-1: "cuTensorMapEncodeTiled is not available from libcuda",
            -2: "cuTensorMapEncodeTiled refused a TMA tensor map"}.get(
                err, f"cudaError {err}")
    return RuntimeError(f"{name} kernel launch failed ({what})")


def sr_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                    rbits: Optional[torch.Tensor] = None, *,
                    trans_b: bool = False) -> torch.Tensor:
    """A @ B (or A @ B.T) with f32 accumulation; SR-cast when rbits given."""
    _shapes(a, b, trans_b)
    bf = b.to(torch.float32)
    acc = torch.matmul(a.to(torch.float32), bf.t() if trans_b else bf)
    return acc if rbits is None else sr_cast_bf16(acc, rbits)


def operands_plan(a: torch.Tensor, b: torch.Tensor,
                  trans_b: bool = False) -> Plan:
    """The plan a call on these operands runs."""
    m, n, k = _shapes(a, b, trans_b)
    if a.dtype == torch.float32:
        return f32_plan(m, n, k)
    return plan(m, n, k, "k", "k" if trans_b else "n", lda=row_stride(a),
                ldb=row_stride(b), aligned=aligned16(a, b))


@functools.lru_cache(maxsize=4096)
def launch_geometry(m: int, n: int, k: int, a_major: str, b_major: str,
                    lda: int, ldb: int, aligned: bool,
                    rows_invariant: bool = True, f32: bool = False,
                    experts: int = 1) -> tuple:
    """(plan, grid_x, grid_y, splits, kb_per_split) of one call (of one
    expert's product, for a batched call)."""
    p = plan(m, n, k, a_major, b_major, lda=lda, ldb=ldb, aligned=aligned,
             rows_invariant=rows_invariant, f32=f32, experts=experts)
    return (p, *p.grid(m, n, k), p.kb_per_split(k))


def _bf16_call(a, b, rbits, out, m: int, n: int, k: int, lda: int,
               ldb: int, trans_b: bool) -> Plan:
    """One launch through the bf16 entry point."""
    p, gx, gy, splits, kb = launch_geometry(
        m, n, k, "k", "k" if trans_b else "n", lda, ldb, aligned16(a, b))
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    err = _bind(build.load("sr_matmul"), "sr_matmul_bf16")(
        build.ptr(a), build.ptr(b), build.ptr(rbits) if rbits is not None
        else None, build.ptr(out), build.ptr(ws) if ws is not None else None,
        m, n, k, lda, ldb, int(trans_b), int(rbits is not None),
        int(p.path == "sm90"), p.bn, splits, kb, gx, gy,
        build.stream_ptr(a.device))
    if err != 0:
        raise launch_error("sr_matmul", err)
    return p


def sr_matmul(a: torch.Tensor, b: torch.Tensor,
              rbits: Optional[torch.Tensor] = None, *,
              trans_b: bool = False) -> torch.Tensor:
    """a (M, K) @ b (K, N) — or a @ b.T for b (N, K) with trans_b.

    Operands both bf16 (unit inner stride, row stride at least the row
    length: column slices are read in place) or both f32 and
    contiguous.  Returns f32 without rbits, SR-bf16 with rbits (int32
    bit patterns, (M, N)).  CPU tensors take the plain version; CUDA
    tensors launch a hand-written kernel on the current stream (no
    synchronisation), and anything the kernels do not take raises.
    """
    m, n, k = _shapes(a, b, trans_b)
    dev = a.device
    if dev.type == "cpu" and b.device.type == "cpu":
        return sr_matmul_plain(a, b, rbits, trans_b=trans_b)
    if dev.type != "cuda" or b.device != dev:
        raise ValueError(f"sr_matmul: operands on {dev} and {b.device}")
    dt = a.dtype
    if b.dtype != dt or dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sr_matmul kernel takes two bf16 or two f32 "
                        f"operands, got {dt}, {b.dtype}")
    f32 = dt == torch.float32
    if f32 and not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("sr_matmul kernel takes contiguous f32 operands")
    lda, ldb = _ld(a), _ld(b)
    if lda is None or ldb is None:
        raise ValueError("sr_matmul kernel takes bf16 operands with unit "
                         "inner stride and rows no closer than their length")
    sr = rbits is not None
    if sr and (rbits.shape != (m, n) or rbits.device != dev
               or rbits.dtype not in (torch.int32, torch.uint32)
               or not rbits.is_contiguous()):
        raise ValueError("sr_matmul: rbits must be contiguous 32-bit (M, N) "
                         "on the operands' device")
    out = torch.empty((m, n), dtype=torch.bfloat16 if sr else torch.float32,
                      device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    if f32:
        # the (i, j, l) counter bank over the plan's tiles: i, j become
        # the grid, l the loop and its splits
        p, gx, gy, splits, kb = launch_geometry(m, n, k, "k", "k" if trans_b
                                                else "n", lda, ldb, True,
                                                f32=True)
        ws = split_workspace(p, m, n, dev)
        err = _bind(build.load("sr_matmul"), "sr_matmul_f32")(
            build.ptr(a), build.ptr(b), build.ptr(rbits) if sr else None,
            build.ptr(out), build.ptr(ws) if ws is not None else None, m, n,
            k, lda, ldb, int(trans_b), int(sr), splits, kb, gx, gy,
            build.stream_ptr(dev))
        if err != 0:
            raise launch_error("sr_matmul", err)
        path = "f32"
    else:
        path = _bf16_call(a, b, rbits, out, m, n, k, lda, ldb, trans_b).path
    COUNTER.n += 1
    PATH_COUNTERS[path].n += 1
    return out


def _batched_shapes(a: torch.Tensor, b: torch.Tensor, trans_b: bool) -> tuple:
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"sr_matmul_batched takes (E, M, K) and (E, K, N) "
                         f"operands, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    e, m, k = a.shape
    n, k2 = (b.shape[1:] if trans_b else (b.shape[2], b.shape[1]))
    if k != k2:
        raise ValueError(f"sr_matmul_batched: inner dims differ: "
                         f"{tuple(a.shape)} x {tuple(b.shape)} "
                         f"(trans_b={trans_b})")
    return e, m, n, k


def live_rows(rows: torch.Tensor, m: int) -> torch.Tensor:
    """(E, m) bool: row r of expert e is live, r < rows[e]."""
    return torch.arange(m, device=rows.device)[None, :] < rows[:, None]


def check_rows(rows: Optional[torch.Tensor], e: int, device,
               name: str) -> None:
    """rows, where given, as the batched kernels take it: (E,) int32,
    contiguous, on the operands' device."""
    if rows is not None and (rows.shape != (e,) or rows.dtype != torch.int32
                             or rows.device != device
                             or not rows.is_contiguous()):
        raise ValueError(f"{name}: rows must be a contiguous (E,) int32 "
                         f"tensor on the operands' device")


def sr_matmul_batched_plain(a: torch.Tensor, b: torch.Tensor, *,
                            trans_b: bool = False,
                            rows: Optional[torch.Tensor] = None,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """a[e] @ b[e] (or a[e] @ b[e].T) for every e with f32 accumulation:
    :func:`sr_matmul_plain` expert by expert, (E, M, N) in out_dtype (the
    f32 result rounded to nearest even for bf16).  rows: the rows of
    out[e] at or past rows[e] are 0 (the kernel's contract: those rows
    of a[e] are zero)."""
    e, m, n, _ = _batched_shapes(a, b, trans_b)
    check_rows(rows, e, a.device, "sr_matmul_batched")
    if e == 0:
        return torch.empty((0, m, n), dtype=out_dtype, device=a.device)
    out = torch.stack([sr_matmul_plain(a[i], b[i], trans_b=trans_b)
                       for i in range(e)])
    if rows is not None:
        out = torch.where(live_rows(rows, m)[..., None], out, 0.0)
    return out.to(out_dtype)


def sr_matmul_batched(a: torch.Tensor, b: torch.Tensor, *,
                      trans_b: bool = False,
                      rows: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a (E, M, K) @ b (E, K, N) expert by expert — or a[e] @ b[e].T for
    b (E, N, K) with trans_b — in ONE launch.

    Operands both bf16, each contiguous and 16-byte aligned, with K and
    N multiples of 8, so that TMA describes them and the output (the
    sm90 path); or both f32 and contiguous (the f32 path, the fp32
    preset).  Anything else raises.  Returns (E, M, N) in out_dtype (f32
    or bf16; bf16 is the f32 result rounded to nearest even, written by
    the bf16 kernel itself).  rows: (E,) int32 on the operands' device,
    each expert's live rows — the contract is that the rows of a[e] at
    or past rows[e] are zero, so the bf16 kernel computes only the row
    tiles below rows[e] and writes zeros past them; the result is still
    a[e] @ b[e] (up to the sign of a zero).  The f32 kernel does the same
    (f32 out).  CPU tensors take the plain version.
    """
    e, m, n, k = _batched_shapes(a, b, trans_b)
    dev = a.device
    if dev.type == "cpu" and b.device.type == "cpu":
        return sr_matmul_batched_plain(a, b, trans_b=trans_b, rows=rows,
                                       out_dtype=out_dtype)
    if dev.type != "cuda" or b.device != dev:
        raise ValueError(f"sr_matmul_batched: operands on {dev} and "
                         f"{b.device}")
    dt = a.dtype
    if b.dtype != dt or dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sr_matmul_batched kernel takes two bf16 or two "
                        f"f32 operands, got {dt}, {b.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sr_matmul_batched writes f32 or bf16, not "
                        f"{out_dtype}")
    check_rows(rows, e, dev, "sr_matmul_batched")
    if dt == torch.float32:
        return _batched_f32(a, b, e, m, n, k, trans_b, rows).to(out_dtype)
    if not (a.is_contiguous() and b.is_contiguous() and aligned16(a, b)
            and k % 8 == 0 and n % 8 == 0):
        raise ValueError(
            "sr_matmul_batched kernel takes contiguous, 16-byte aligned "
            "operands with 16-byte rows (K and N multiples of 8): the TMA "
            "describes no other")
    out = torch.empty((e, m, n), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    p = launch_geometry(m, n, k, "k", "k" if trans_b else "n", k,
                        k if trans_b else n, True, experts=e)[0]
    _batched_call(a, b, out, p, trans_b, rows)
    COUNTER.n += 1
    PATH_COUNTERS["sm90"].n += 1
    BATCHED_COUNTER.n += 1
    return out


def _batched_call(a, b, out, p: Plan, trans_b: bool,
                  rows: Optional[torch.Tensor] = None) -> None:
    """One launch of the batched C entry under plan `p` into `out` (f32
    or bf16; operands and rows as :func:`sr_matmul_batched` checked
    them)."""
    e, m, n, k = _batched_shapes(a, b, trans_b)
    gx, gy, _ = p.grid(m, n, k)
    ws = (torch.empty((p.splits, e, m, n), dtype=torch.float32,
                      device=a.device) if p.splits > 1 else None)
    err = _bind(build.load("sr_matmul"), "sr_matmul_batched_bf16")(
        build.ptr(a), build.ptr(b), build.ptr(out),
        build.ptr(ws) if ws is not None else None,
        build.ptr(rows) if rows is not None else None, e, m, n, k,
        int(trans_b), int(out.dtype == torch.bfloat16), p.bn, p.splits,
        p.kb_per_split(k), gx, gy, build.stream_ptr(a.device))
    if err != 0:
        raise launch_error("sr_matmul_batched", err)


def _batched_f32(a, b, e: int, m: int, n: int, k: int, trans_b: bool,
                 rows: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`sr_matmul_batched` of two f32 operands: one launch of
    ``csrc/sgemm_sm90_batched.cuh``'s kernel under ``f32_plan(m, n, k,
    experts=e)`` over each expert's `rows` live rows."""
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("sr_matmul_batched kernel takes contiguous f32 "
                         "operands")
    out = torch.empty((e, m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    p = f32_plan(m, n, k, experts=e)
    gx, gy, _ = p.grid(m, n, k)
    ws = split_workspace(p, m, n, a.device, experts=e)
    err = _bind(build.load("sr_matmul"), "sr_matmul_batched_f32")(
        build.ptr(a), build.ptr(b), build.ptr(out),
        build.ptr(ws) if ws is not None else None,
        build.ptr(rows) if rows is not None else None, e, m, n, k,
        int(trans_b), p.splits, p.kb_per_split(k), gx, gy,
        build.stream_ptr(a.device))
    if err != 0:
        raise launch_error("sr_matmul_batched", err)
    COUNTER.n += 1
    PATH_COUNTERS["f32"].n += 1
    BATCHED_COUNTER.n += 1
    return out
