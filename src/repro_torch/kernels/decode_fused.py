"""fused_attn_unit and fused_ffn: fused decode words for B arena rows.

:func:`fused_attn_unit` is one decode step of one attention layer; its
FF half alone is :func:`fused_ffn` (norm2 + FF + residual, for units
whose mixer stays per-op: rwkv6), with :func:`fused_ffn_plain` beside it.

Port of the TPU kernel ``repro/kernels/decode_fused.py::fused_attn_unit``.
The CUDA kernels are ``csrc/decode_fused.cu`` (its header gives the
design and what bounds it on the H100): seven launches per call (five
without the FF, three for :func:`fused_ffn`) whose tiles, splits and
workspace :func:`decode_plan` lays out from the shapes alone.
:func:`fused_attn_unit_plain` is its plain torch version, step for step
the TPU kernel's arithmetic:

1. f32 norm1 (rmsnorm eps 1e-6, layernorm 1e-5);
2. x . qkv_w with f32 accumulation, + f32 bias, cast to bf16;
3. RoPE in f32 at ``pos`` with freqs = 1 / theta^(2i/hd);
4. k, v and pos written into ring slot ``pos % S``;
5. GQA scores in f32, mask 0 <= kv_pos <= pos (and the window), -1e30;
6. exp(s - m) kept in f32 for PV, / max(l, 1e-30), cast to bf16 — or,
   with ``kv_split``, the kernel's split over the cache positions: per
   split the partials m_i, l_i, o_i, merged in split order;
7. o-projection with f32 accumulation, cast to bf16, bf16 residual;
8. with_ffn: norm2, the FF streamed by column tiles of ``tn`` (snapped
   down to a divisor of f) with gate/up tiles paired for gated acts,
   ``x + acc.astype(bf16)``.

Unlike the TPU kernel, which returns new caches, both versions update the
cache IN PLACE, and only on rows where ``active`` is true: an inactive
arena row keeps its cache exactly, as the reference engine's restore
after the step guarantees.  Its y is computed all the same and discarded
by the caller.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# one count per call of each word; the :launches counters add the kernel
# launches that the C entry reports having made (decode_plan(...).launches
# of them when the call succeeds)
COUNTER = build.LaunchCounter("fused_attn_unit")
FFN_COUNTER = build.LaunchCounter("fused_ffn")
LAUNCHES = build.LaunchCounter("fused_attn_unit:launches")
FFN_LAUNCHES = build.LaunchCounter("fused_ffn:launches")
NEG_INF = -1e30
_NORM_CODE = {"rmsnorm": 1, "layernorm": 2}
_ACT_CODE = {"swiglu": 0, "geglu": 1, "gelu": 2, "relu_sq": 3}
_MAX_GROUP = 16                   # query heads per KV head (csrc MAXG)
_HEAD_DIMS = (16, 32, 64, 128)    # head_dim the attention kernel takes
_MAX_D = 8192                     # the norm kernel holds a row in registers

# The kernels' tiles (csrc/decode_fused.cu): a weight product's block
# covers 64 output columns (and the same 64 of the up half when gated),
# 64 rows and a range of 64-deep k-blocks; an attention block covers
# ATTN_SPLIT cache positions.  The split count of a product brings its
# blocks to at least SPLIT_BLOCKS where the column tiles alone do not:
# about 3/4 of the H100's 132 SMs.  Filling all 132 measured slower
# (launch/bench_decode.py, PERF.md): rwkv6's FF in, 112 column tiles,
# then needs a second split whose reduction costs more than the 20 SMs
# it adds.
GEMM_BN = GEMM_BK = GEMM_ROWS = 64
ATTN_SPLIT = 64
SPLIT_BLOCKS = 100
_ALIGN = 256                      # workspace buffers start at multiples of it


class GemmPlan(NamedTuple):
    """One weight product of a decode word: out (B, n) from A (B, k);
    `boxes` is 2 for a gated product (gate and up columns together)."""
    n: int
    k: int
    boxes: int
    tiles: int
    splits: int

    def k_ranges(self) -> list:
        """The [k0, k1) reduction range of each split, in split order
        (csrc: k-blocks z kb / splits .. (z + 1) kb / splits)."""
        kb = math.ceil(self.k / GEMM_BK)
        return [(z * kb // self.splits * GEMM_BK,
                 min(self.k, (z + 1) * kb // self.splits * GEMM_BK))
                for z in range(self.splits)]

    def blocks(self, rows: int) -> int:
        return self.tiles * self.splits * math.ceil(rows / GEMM_ROWS)


@functools.lru_cache(maxsize=256)
def gemm_plan(n: int, k: int, boxes: int = 1) -> GemmPlan:
    """The split of one decode product, from (n, k) alone — never from
    the number of rows, so a row's sums do not depend on how many rows
    share the call: as many splits as bring the blocks to SPLIT_BLOCKS,
    at most one per k-block."""
    tiles = math.ceil(n / GEMM_BN)
    kb = math.ceil(k / GEMM_BK)
    return GemmPlan(n, k, boxes, tiles,
                    max(1, min(kb, math.ceil(SPLIT_BLOCKS / tiles))))


def attn_split(S: int) -> tuple:
    """(positions per attention block, number of splits) of a cache of S
    positions: fixed splits of ATTN_SPLIT, so the merge order depends on
    S alone (not on B, the heads or the cache's fill)."""
    return ATTN_SPLIT, math.ceil(S / ATTN_SPLIT)


def _part_stride(G: int, hd: int) -> int:
    """Floats of one attention split's partials (csrc part_stride): o_i
    (G hd), m_i and l_i (G each), padded to a multiple of 4."""
    return G * hd + -(-2 * G // 4) * 4


# int64 fields of the layout handed to the kernels (csrc Layout enum):
# split counts, the attention's split count, byte offsets of the
# workspace's buffers, and counter offsets (in counters) per launch
LAYOUT_FIELDS = ("sp_qkv", "sp_o", "sp_in", "sp_out", "attn_nsplit",
                 "h1", "o", "x1", "h2", "h", "attn", "part", "cnt",
                 "cnt_in", "cnt_out", "cnt_attn", "n_cnt")
# products whose f32 partials the next launch sums (csrc raw<P>): QKV's
# in the attention, the o-projection's in the residual + norm2 pass
RAW_PRODUCTS = ("qkv", "o")


class DecodePlan(NamedTuple):
    """Every launch of one decode word call: the weight products' plans,
    the attention's split, the workspace layout and its size."""
    products: dict              # name -> GemmPlan, in launch order
    attn_nsplit: int            # 0: no attention (fused_ffn)
    layout: dict                # LAYOUT_FIELDS -> int
    ws_bytes: int
    launches: int
    args: object                # the layout as a ctypes int64 array


@functools.lru_cache(maxsize=256)
def decode_plan(B: int, d: int, *, f: int = 0, gated: bool = False,
                heads: int = 0, kv_heads: int = 0, head_dim: int = 0,
                S: int = 0, attention: bool = True,
                with_ffn: bool = True) -> DecodePlan:
    """The launches of a fused_attn_unit call (attention=True) or a
    fused_ffn call (attention=False) on B rows: norm1, QKV, attention,
    o, the residual (+ norm2), then (with_ffn) FF in and FF out; fused_ffn
    is norm2, FF in, FF out.  Buffers 256-byte aligned in one
    workspace."""
    H, K, hd = heads, kv_heads, head_dim
    prods = {}
    if attention:
        prods["qkv"] = gemm_plan((H + 2 * K) * hd, d)
        prods["o"] = gemm_plan(d, H * hd)
    if with_ffn:
        prods["ffn_in"] = gemm_plan(f, d, 2 if gated else 1)
        prods["ffn_out"] = gemm_plan(d, f)
    nsplit = attn_split(S)[1] if attention else 0
    lay = dict.fromkeys(LAYOUT_FIELDS, 0)
    for name, key in (("qkv", "sp_qkv"), ("o", "sp_o"), ("ffn_in", "sp_in"),
                      ("ffn_out", "sp_out")):
        lay[key] = prods[name].splits if name in prods else 1
    lay["attn_nsplit"] = nsplit
    rows = math.ceil(B / GEMM_ROWS)
    G = H // max(K, 1)
    sizes = {"h1": 2 * B * d if attention else 0,
             "o": 2 * B * H * hd,
             "x1": 2 * B * d if attention and with_ffn else 0,
             "h2": 2 * B * d if with_ffn else 0,
             "h": 2 * B * f if with_ffn else 0,
             "attn": 4 * B * K * nsplit * _part_stride(G, hd)
             if nsplit > 1 else 0,
             "part": max([4 * p.splits * B * p.boxes * p.n
                          for name, p in prods.items()
                          if p.splits > 1 or name in RAW_PRODUCTS],
                         default=0)}
    n_cnt = 0
    for name, key in (("ffn_in", "cnt_in"), ("ffn_out", "cnt_out")):
        p = prods.get(name)
        if p is not None and p.splits > 1:
            lay[key] = n_cnt
            n_cnt += p.tiles * rows
    if nsplit > 1:
        lay["cnt_attn"] = n_cnt
        n_cnt += B * K
    lay["n_cnt"] = n_cnt
    sizes["cnt"] = 4 * n_cnt
    off = 0
    for key, size in sizes.items():
        lay[key] = off
        off += -(-size // _ALIGN) * _ALIGN
    launches = (5 if attention else 1) + (2 if with_ffn else 0)
    args = (ctypes.c_longlong * len(LAYOUT_FIELDS))(
        *(lay[k] for k in LAYOUT_FIELDS))
    return DecodePlan(prods, nsplit, lay, max(off, _ALIGN), launches, args)


def _clip_block_n(block_n: int, f: int) -> int:
    """Largest divisor of f that is <= block_n (>= 1)."""
    tn = max(1, min(block_n, f))
    while f % tn:
        tn -= 1
    return tn


def _norm_f32(x, scale, bias, kind: str):
    """f32 norm on (B, d) rows; returns x.dtype."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def _rope_f32(x, pos, theta: float):
    """RoPE on (B, nh, hd) at per-row positions pos (B,); returns x.dtype."""
    hd = x.shape[-1]
    i2 = torch.arange(hd // 2, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (theta ** (2.0 * i2 / hd))
    ang = (pos.to(torch.float32)[:, None] * freqs)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :hd // 2], xf[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _ffn_stream(x, h2, w_in, w_out, *, act: str, tn: int):
    """x + FF(h2), the FF streamed by tn-column tiles into an f32 acc."""
    f32 = torch.float32
    f = w_out.shape[0]
    gated = act in ("swiglu", "geglu")
    h2f = h2.to(f32)
    acc = torch.zeros((x.shape[0], x.shape[1]), dtype=f32, device=x.device)
    for c0 in range(0, f, tn):
        if gated:
            g = h2f @ w_in[:, c0:c0 + tn].to(f32)
            u = h2f @ w_in[:, f + c0:f + c0 + tn].to(f32)
            gate = F.silu(g) if act == "swiglu" else F.gelu(g,
                                                            approximate="tanh")
            hj = (gate * u).to(x.dtype)
        else:
            hj = h2f @ w_in[:, c0:c0 + tn].to(f32)
            if act == "relu_sq":
                r = F.relu(hj)
                hj = (r * r).to(x.dtype)
            else:
                hj = F.gelu(hj, approximate="tanh").to(x.dtype)
        acc = acc + hj.to(f32) @ w_out[c0:c0 + tn].to(f32)
    return x + acc.to(x.dtype)


def _vec(arr, n: int, fill: float, device) -> torch.Tensor:
    """An optional (n,) vector as contiguous f32 (absent -> fill)."""
    if arr is None:
        return torch.full((n,), fill, dtype=torch.float32, device=device)
    return arr.reshape(n).to(torch.float32).contiguous()


def _attend(qh, kc, vc, valid, scale: float, kv_split: Optional[int]):
    """GQA attention of qh (B, K, G, hd) over the caches (B, S, K, hd)
    with the (B, S) mask: one softmax over all S positions, or (kv_split)
    the kernel's split over the positions — per split of kv_split
    positions m_i = max s, l_i = sum exp(s - m_i), o_i = sum exp(s -
    m_i) v, then o = sum exp(m_i - m) o_i / max(sum exp(m_i - m) l_i,
    1e-30), summed in split order.  Returns f32 (B, K, G, hd)."""
    f32 = torch.float32
    s = torch.einsum("bkgh,bskh->bkgs", qh, kc.to(f32)) * scale
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    if kv_split is None:
        m = torch.amax(s, dim=-1, keepdim=True)
        pe = torch.exp(s - m)
        l = torch.sum(pe, dim=-1, keepdim=True)
        o = torch.einsum("bkgs,bskh->bkgh", pe, vc.to(f32))
        return o / torch.clamp_min(l, 1e-30)
    parts = []
    for s0 in range(0, s.shape[-1], kv_split):
        si = s[..., s0:s0 + kv_split]
        mi = torch.amax(si, dim=-1, keepdim=True)
        pe = torch.exp(si - mi)
        parts.append((mi, torch.sum(pe, dim=-1, keepdim=True),
                      torch.einsum("bkgs,bskh->bkgh", pe,
                                   vc[:, s0:s0 + kv_split].to(f32))))
    m = torch.amax(torch.stack([mi for mi, _, _ in parts]), dim=0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for mi, li, oi in parts:
        w = torch.exp(mi - m)
        num = num + w * oi
        den = den + w * li
    return num / torch.clamp_min(den, 1e-30)


def fused_attn_unit_plain(x, cache_k, cache_v, cache_pos, pos, *, n1s, n1b,
                          qkv_w, qkv_b, o_w, n2s, n2b, w_in, w_out, heads,
                          kv_heads, head_dim, rope_theta, window, norm_kind,
                          act, tn, with_ffn, active,
                          kv_split: Optional[int] = None):
    """Plain torch version; vectors n1s/n1b/n2s/n2b/qkv_b are (n,) f32.
    kv_split: None takes one softmax over the cache (the TPU kernel's
    order), an int the kernel's split over the positions (_attend)."""
    f32 = torch.float32
    dt = x.dtype
    B = x.shape[0]
    S = cache_k.shape[1]
    H, K, hd = heads, kv_heads, head_dim
    G = H // K
    rows = torch.arange(B, device=x.device)

    h = _norm_f32(x, n1s, n1b, norm_kind)
    qkv = (h.to(f32) @ qkv_w.to(f32) + qkv_b).to(dt)
    q = _rope_f32(qkv[:, :H * hd].reshape(B, H, hd), pos, rope_theta)
    k1 = _rope_f32(qkv[:, H * hd:(H + K) * hd].reshape(B, K, hd), pos,
                   rope_theta)
    v1 = qkv[:, (H + K) * hd:].reshape(B, K, hd)

    # the attention reads every row's cache with its new slot written ...
    slot = pos.to(torch.int64) % S
    kc, vc, kvp = cache_k.clone(), cache_v.clone(), cache_pos.clone()
    kc[rows, slot] = k1.to(kc.dtype)
    vc[rows, slot] = v1.to(vc.dtype)
    kvp[rows, slot] = pos.to(kvp.dtype)
    # ... but only active rows keep the append
    act_rows = rows[active.to(torch.bool)]
    cache_k[act_rows] = kc[act_rows]
    cache_v[act_rows] = vc[act_rows]
    cache_pos[act_rows] = kvp[act_rows]

    p = pos.to(kvp.dtype)[:, None]
    valid = (kvp >= 0) & (kvp <= p)
    if window is not None:
        valid &= (p - kvp) < window
    o = _attend(q.reshape(B, K, G, hd).to(f32), kc, vc, valid,
                1.0 / math.sqrt(hd), kv_split)
    o = o.to(dt).reshape(B, H * hd)

    x = x + (o.to(f32) @ o_w.to(f32)).to(dt)
    if with_ffn:
        h2 = _norm_f32(x, n2s, n2b, norm_kind)
        x = _ffn_stream(x, h2, w_in, w_out, act=act, tn=tn)
    return x


@functools.lru_cache(maxsize=None)
def _entry(lib: ctypes.CDLL, name: str):
    """A C entry point without argtypes: pointers go as ctypes.c_void_p
    (build.ptr) or None, ints as Python ints, floats as ctypes.c_float."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    return fn


def _vec_arg(t, n: int, dev, what: str) -> tuple:
    """(pointer or None, 1 if bf16) of an optional (n,) vector: f32 and
    bf16 are read where they lie; another type is copied to f32."""
    if t is None:
        return None, 0
    if t.device != dev:
        raise ValueError(f"{what} on {t.device}, rows on {dev}")
    if t.numel() != n:
        raise ValueError(f"{what} has {t.numel()} elements, want {n}")
    if t.dtype not in (torch.float32, torch.bfloat16) or not t.is_contiguous():
        t = t.reshape(n).to(torch.float32).contiguous()
    return t, int(t.dtype == torch.bfloat16)


def _check_operands(name: str, dev, tensors) -> None:
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors on "
                             f"one device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bf16 activations, caches "
                            f"and weights")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel takes 16-byte aligned tensors")


def fused_attn_unit(x, cache_k, cache_v, cache_pos, pos, *,
                    norm1_scale=None, norm1_bias=None, qkv_w, qkv_bias, o_w,
                    norm2_scale=None, norm2_bias=None, w_in=None, w_out=None,
                    heads: int, kv_heads: int, head_dim: int,
                    rope_theta: float, window: Optional[int] = None,
                    norm_kind: str = "rmsnorm", act: str = "swiglu",
                    block_n: int = 256, with_ffn: bool = True,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused decode step of an attention unit for B arena rows.

    x: (B, d); cache_k/cache_v: (B, S, K, hd), cache_pos: (B, S) int32 —
    all three updated in place on active rows; pos: (B,) int32; active:
    (B,) bool (None = every row).  Returns y (B, d).  with_ffn=False
    stops after the o-projection residual (units whose FF is not dense).
    CPU tensors take the plain version; CUDA tensors launch the kernels
    (decode_plan(...).launches of them).
    """
    B, d = x.shape
    S, K, hd = cache_k.shape[1:]
    if K != kv_heads or hd != head_dim or heads % kv_heads:
        raise ValueError(f"fused_attn_unit: cache {tuple(cache_k.shape)} vs "
                         f"heads={heads} kv_heads={kv_heads} hd={head_dim}")
    if norm_kind not in _NORM_CODE or act not in _ACT_CODE:
        raise ValueError(f"fused_attn_unit: norm {norm_kind!r} / act {act!r}")
    qn = (heads + 2 * kv_heads) * head_dim
    dev = x.device
    f = w_out.shape[0] if with_ffn else 0
    if dev.type == "cpu":
        if active is None:
            active = torch.ones((B,), dtype=torch.bool)
        return fused_attn_unit_plain(
            x, cache_k, cache_v, cache_pos, pos,
            n1s=_vec(norm1_scale, d, 1.0, dev),
            n1b=_vec(norm1_bias, d, 0.0, dev), qkv_w=qkv_w,
            qkv_b=_vec(qkv_bias, qn, 0.0, dev), o_w=o_w,
            n2s=_vec(norm2_scale, d, 1.0, dev),
            n2b=_vec(norm2_bias, d, 0.0, dev), w_in=w_in, w_out=w_out,
            heads=heads, kv_heads=kv_heads, head_dim=head_dim,
            rope_theta=rope_theta, window=window, norm_kind=norm_kind,
            act=act, tn=_clip_block_n(block_n, f) if with_ffn else 1,
            with_ffn=with_ffn, active=active)
    if dev.type != "cuda":
        raise ValueError(f"fused_attn_unit: tensors on {dev}")

    gated = act in ("swiglu", "geglu")
    _check_operands("fused_attn_unit", dev,
                    [x, cache_k, cache_v, qkv_w, o_w]
                    + ([w_in, w_out] if with_ffn else []))
    if cache_pos.dtype != torch.int32 or cache_pos.shape != (B, S) or \
            cache_pos.device != dev or not cache_pos.is_contiguous():
        raise TypeError("fused_attn_unit: cache_pos must be contiguous int32 "
                        "(B, S) on the rows' device")
    if hd not in _HEAD_DIMS or heads // kv_heads > _MAX_GROUP:
        raise ValueError(f"fused_attn_unit kernel takes head_dim in "
                         f"{_HEAD_DIMS} and <= {_MAX_GROUP} query heads per "
                         f"KV head")
    if d % 8 or f % 8 or d > _MAX_D:
        raise ValueError(f"fused_attn_unit kernel takes d <= {_MAX_D} and "
                         f"d, d_ff multiples of 8 (16-byte rows for the TMA)")
    if qkv_w.shape != (d, qn) or o_w.shape != (heads * hd, d) or (
            with_ffn and (w_in.shape != (d, 2 * f if gated else f)
                          or w_out.shape != (f, d))):
        raise ValueError("fused_attn_unit: weight shapes do not match")
    if pos.dtype != torch.int32 or pos.device != dev:
        pos = pos.to(device=dev, dtype=torch.int32)
    pos = pos.contiguous()
    act_i32 = 0
    if active is not None:
        if active.device != dev or active.dtype not in (torch.bool,
                                                        torch.int32):
            active = active.to(device=dev, dtype=torch.bool)
        act_i32 = int(active.dtype == torch.int32)
        active = active.contiguous()
    vecs = [_vec_arg(t, n, dev, what) for t, n, what in (
        (norm1_scale, d, "norm1_scale"), (norm1_bias, d, "norm1_bias"),
        (norm2_scale, d, "norm2_scale"), (norm2_bias, d, "norm2_bias"),
        (qkv_bias, qn, "qkv_bias"))]
    vbits = sum(bf << i for i, (_, bf) in enumerate(vecs))
    vp = [None if t is None else build.ptr(t) for t, _ in vecs]
    plan = decode_plan(B, d, f=f, gated=gated, heads=heads,
                       kv_heads=kv_heads, head_dim=hd, S=S,
                       with_ffn=with_ffn)
    ws = torch.empty((plan.ws_bytes,), dtype=torch.uint8, device=dev)
    y = torch.empty((B, d), dtype=torch.bfloat16, device=dev)
    launched = ctypes.c_int(0)
    err = _entry(build.load("decode_fused"), "fused_attn_unit_bf16")(
        build.ptr(x), build.ptr(cache_k), build.ptr(cache_v),
        build.ptr(cache_pos), build.ptr(pos),
        None if active is None else build.ptr(active), act_i32,
        vp[0], vp[1], build.ptr(qkv_w), vp[4], build.ptr(o_w), vp[2],
        vp[3], build.ptr(w_in) if with_ffn else None,
        build.ptr(w_out) if with_ffn else None, build.ptr(y),
        build.ptr(ws), plan.args, vbits, B, d, heads, kv_heads, hd, S, f,
        0 if window is None else int(window), _NORM_CODE[norm_kind],
        _ACT_CODE[act], int(with_ffn), ctypes.c_float(rope_theta),
        build.stream_ptr(dev), ctypes.byref(launched))
    LAUNCHES.n += launched.value
    if err != 0:
        raise launch_error("fused_attn_unit", err)
    COUNTER.n += 1
    return y


def launch_error(name: str, err: int) -> RuntimeError:
    what = {-1: "cuTensorMapEncodeTiled is not available from libcuda",
            -2: "cuTensorMapEncodeTiled refused a TMA tensor map"}.get(
                err, f"cudaError {err}")
    return RuntimeError(f"{name} kernel launch failed ({what})")


def fused_ffn_plain(x, *, n2s, n2b, w_in, w_out, norm_kind, act, tn):
    """Plain torch version of :func:`fused_ffn`; n2s/n2b are (d,) f32."""
    h2 = _norm_f32(x, n2s, n2b, norm_kind)
    return _ffn_stream(x, h2, w_in, w_out, act=act, tn=tn)


def fused_ffn(x, *, norm2_scale=None, norm2_bias=None, w_in, w_out,
              norm_kind: str = "rmsnorm", act: str = "swiglu",
              block_n: int = 256) -> torch.Tensor:
    """Fused norm2 + FF + residual: x (B, d) -> x + FF(norm(x)) (B, d).

    w_in: (d, 2f) for gated acts else (d, f); w_out: (f, d).  CPU
    tensors take the plain version; CUDA tensors launch the kernels
    (three launches: norm2, FF in, FF out).
    """
    B, d = x.shape
    f = w_out.shape[0]
    gated = act in ("swiglu", "geglu")
    if norm_kind not in _NORM_CODE or act not in _ACT_CODE:
        raise ValueError(f"fused_ffn: norm {norm_kind!r} / act {act!r}")
    if w_in.shape != (d, 2 * f if gated else f) or w_out.shape != (f, d):
        raise ValueError(f"fused_ffn: weights {tuple(w_in.shape)}, "
                         f"{tuple(w_out.shape)} for d={d}, act={act}")
    dev = x.device
    if dev.type == "cpu":
        return fused_ffn_plain(x, n2s=_vec(norm2_scale, d, 1.0, dev),
                               n2b=_vec(norm2_bias, d, 0.0, dev), w_in=w_in,
                               w_out=w_out, norm_kind=norm_kind, act=act,
                               tn=_clip_block_n(block_n, f))
    if dev.type != "cuda":
        raise ValueError(f"fused_ffn: tensors on {dev}")
    _check_operands("fused_ffn", dev, (x, w_in, w_out))
    if d % 8 or f % 8 or d > _MAX_D:
        raise ValueError(f"fused_ffn kernel takes d <= {_MAX_D} and d, d_ff "
                         f"multiples of 8 (16-byte rows for the TMA)")
    (n2s, s_bf), (n2b, b_bf) = (
        _vec_arg(norm2_scale, d, dev, "norm2_scale"),
        _vec_arg(norm2_bias, d, dev, "norm2_bias"))
    plan = decode_plan(B, d, f=f, gated=gated, attention=False)
    ws = torch.empty((plan.ws_bytes,), dtype=torch.uint8, device=dev)
    y = torch.empty((B, d), dtype=torch.bfloat16, device=dev)
    launched = ctypes.c_int(0)
    err = _entry(build.load("decode_fused"), "fused_ffn_bf16")(
        build.ptr(x), None if n2s is None else build.ptr(n2s),
        None if n2b is None else build.ptr(n2b), build.ptr(w_in),
        build.ptr(w_out), build.ptr(y), build.ptr(ws), plan.args,
        s_bf | (b_bf << 1), B, d, f, _NORM_CODE[norm_kind], _ACT_CODE[act],
        build.stream_ptr(dev), ctypes.byref(launched))
    FFN_LAUNCHES.n += launched.value
    if err != 0:
        raise launch_error("fused_ffn", err)
    FFN_COUNTER.n += 1
    return y
