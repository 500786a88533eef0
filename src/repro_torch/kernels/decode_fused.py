"""fused_attn_unit and fused_ffn: fused decode words for B arena rows.

:func:`fused_attn_unit` is one decode step of one attention layer; its
FF half alone is :func:`fused_ffn` (norm2 + FF + residual, for units
whose mixer stays per-op: rwkv6), with :func:`fused_ffn_plain` beside it.

Port of the TPU kernel ``repro/kernels/decode_fused.py::fused_attn_unit``.
The CUDA kernel is ``csrc/decode_fused.cu`` (five launches per layer;
its header gives the design and what bounds it on the H100).
:func:`fused_attn_unit_plain` is its plain torch version, step for step
the TPU kernel's arithmetic:

1. f32 norm1 (rmsnorm eps 1e-6, layernorm 1e-5);
2. x . qkv_w with f32 accumulation, + f32 bias, cast to bf16;
3. RoPE in f32 at ``pos`` with freqs = 1 / theta^(2i/hd);
4. k, v and pos written into ring slot ``pos % S``;
5. GQA scores in f32, mask 0 <= kv_pos <= pos (and the window), -1e30;
6. exp(s - m) kept in f32 for PV, / max(l, 1e-30), cast to bf16;
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
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

COUNTER = build.LaunchCounter("fused_attn_unit")
FFN_COUNTER = build.LaunchCounter("fused_ffn")
NEG_INF = -1e30
_NORM_CODE = {"rmsnorm": 1, "layernorm": 2}
_ACT_CODE = {"swiglu": 0, "geglu": 1, "gelu": 2, "relu_sq": 3}
_MAX_GROUP = 16                   # query heads per KV head (csrc MAXG)


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


def fused_attn_unit_plain(x, cache_k, cache_v, cache_pos, pos, *, n1s, n1b,
                          qkv_w, qkv_b, o_w, n2s, n2b, w_in, w_out, heads,
                          kv_heads, head_dim, rope_theta, window, norm_kind,
                          act, tn, with_ffn, active):
    """Plain torch version; vectors n1s/n1b/n2s/n2b/qkv_b are (n,) f32."""
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

    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(B, K, G, hd).to(f32)
    s = torch.einsum("bkgh,bskh->bkgs", qh, kc.to(f32)) * scale
    p = pos.to(kvp.dtype)[:, None]
    valid = (kvp >= 0) & (kvp <= p)
    if window is not None:
        valid &= (p - kvp) < window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    pe = torch.exp(s - m)
    l = torch.sum(pe, dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskh->bkgh", pe, vc.to(f32))
    o = (o / torch.clamp_min(l, 1e-30)).to(dt).reshape(B, H * hd)

    x = x + (o.to(f32) @ o_w.to(f32)).to(dt)
    if with_ffn:
        h2 = _norm_f32(x, n2s, n2b, norm_kind)
        x = _ffn_stream(x, h2, w_in, w_out, act=act, tn=tn)
    return x


def _bind(lib: ctypes.CDLL):
    fn = lib.fused_attn_unit_bf16
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 11 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    CPU tensors take the plain version; CUDA tensors launch the kernel.
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
    n1s = _vec(norm1_scale, d, 1.0, dev)
    n1b = _vec(norm1_bias, d, 0.0, dev)
    n2s = _vec(norm2_scale, d, 1.0, dev)
    n2b = _vec(norm2_bias, d, 0.0, dev)
    qb = _vec(qkv_bias, qn, 0.0, dev)
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    f = w_out.shape[0] if with_ffn else 0
    tn = _clip_block_n(block_n, f) if with_ffn else 1
    if dev.type == "cpu":
        return fused_attn_unit_plain(
            x, cache_k, cache_v, cache_pos, pos, n1s=n1s, n1b=n1b,
            qkv_w=qkv_w, qkv_b=qb, o_w=o_w, n2s=n2s, n2b=n2b, w_in=w_in,
            w_out=w_out, heads=heads, kv_heads=kv_heads, head_dim=head_dim,
            rope_theta=rope_theta, window=window, norm_kind=norm_kind,
            act=act, tn=tn, with_ffn=with_ffn, active=active)
    if dev.type != "cuda":
        raise ValueError(f"fused_attn_unit: tensors on {dev}")

    bf_ops = [x, cache_k, cache_v, qkv_w, o_w] + ([w_in, w_out]
                                                  if with_ffn else [])
    for t in bf_ops + [cache_pos]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("fused_attn_unit kernel takes contiguous "
                             "tensors on one device")
    if any(t.dtype != torch.bfloat16 for t in bf_ops):
        raise TypeError("fused_attn_unit kernel takes bf16 activations, "
                        "caches and weights")
    if cache_pos.dtype != torch.int32 or cache_pos.shape != (B, S):
        raise TypeError("fused_attn_unit: cache_pos must be int32 (B, S)")
    if hd % 8 or 128 % hd or heads // kv_heads > _MAX_GROUP:
        raise ValueError(f"fused_attn_unit kernel takes head_dim in "
                         f"{{8,16,32,64,128}} and <= {_MAX_GROUP} query "
                         f"heads per KV head")
    gated = act in ("swiglu", "geglu")
    if qkv_w.shape != (d, qn) or o_w.shape != (heads * hd, d) or (
            with_ffn and w_in.shape != (d, 2 * f if gated else f)):
        raise ValueError("fused_attn_unit: weight shapes do not match")
    pos32 = pos.to(device=dev, dtype=torch.int32).contiguous()
    act32 = active.to(device=dev, dtype=torch.int32).contiguous()
    emp = lambda *s: torch.empty(s, dtype=torch.bfloat16, device=dev)
    qkv_buf, o_buf, y = emp(B, qn), emp(B, heads * hd), emp(B, d)
    x1_buf, h_buf = (emp(B, d), emp(B, f)) if with_ffn else (y, y)
    null = ctypes.c_void_p(None)
    fn = _bind(build.load("decode_fused"))
    err = fn(build.ptr(x), build.ptr(cache_k), build.ptr(cache_v),
             build.ptr(cache_pos), build.ptr(pos32), build.ptr(act32),
             build.ptr(n1s), build.ptr(n1b), build.ptr(qkv_w), build.ptr(qb),
             build.ptr(o_w), build.ptr(n2s), build.ptr(n2b),
             build.ptr(w_in) if with_ffn else null,
             build.ptr(w_out) if with_ffn else null,
             build.ptr(qkv_buf), build.ptr(o_buf), build.ptr(x1_buf),
             build.ptr(h_buf), build.ptr(y),
             B, d, heads, kv_heads, hd, S, f,
             0 if window is None else int(window),
             _NORM_CODE[norm_kind], _ACT_CODE[act], int(with_ffn),
             float(rope_theta), build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(
            f"fused_attn_unit kernel launch failed (cudaError {err})")
    COUNTER.n += 1
    return y


def _bind_ffn(lib: ctypes.CDLL):
    fn = lib.fused_ffn_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_ffn_plain(x, *, n2s, n2b, w_in, w_out, norm_kind, act, tn):
    """Plain torch version of :func:`fused_ffn`; n2s/n2b are (d,) f32."""
    h2 = _norm_f32(x, n2s, n2b, norm_kind)
    return _ffn_stream(x, h2, w_in, w_out, act=act, tn=tn)


def fused_ffn(x, *, norm2_scale=None, norm2_bias=None, w_in, w_out,
              norm_kind: str = "rmsnorm", act: str = "swiglu",
              block_n: int = 256) -> torch.Tensor:
    """Fused norm2 + FF + residual: x (B, d) -> x + FF(norm(x)) (B, d).

    w_in: (d, 2f) for gated acts else (d, f); w_out: (f, d).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (two
    launches: csrc/decode_fused.cu's 4 and 5).
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
    n2s = _vec(norm2_scale, d, 1.0, dev)
    n2b = _vec(norm2_bias, d, 0.0, dev)
    if dev.type == "cpu":
        return fused_ffn_plain(x, n2s=n2s, n2b=n2b, w_in=w_in, w_out=w_out,
                               norm_kind=norm_kind, act=act,
                               tn=_clip_block_n(block_n, f))
    if dev.type != "cuda":
        raise ValueError(f"fused_ffn: tensors on {dev}")
    for t in (x, w_in, w_out):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("fused_ffn kernel takes contiguous tensors on "
                             "one device")
        if t.dtype != torch.bfloat16:
            raise TypeError("fused_ffn kernel takes bf16 rows and weights")
    h_buf = torch.empty((B, f), dtype=torch.bfloat16, device=dev)
    y = torch.empty((B, d), dtype=torch.bfloat16, device=dev)
    fn = _bind_ffn(build.load("decode_fused"))
    err = fn(build.ptr(x), build.ptr(n2s), build.ptr(n2b), build.ptr(w_in),
             build.ptr(w_out), build.ptr(h_buf), build.ptr(y), B, d, f,
             _NORM_CODE[norm_kind], _ACT_CODE[act], build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"fused_ffn kernel launch failed (cudaError {err})")
    FFN_COUNTER.n += 1
    return y
