"""The port's kernels against the JAX package's Pallas kernels.

Same inputs, made with numpy from a seed, go through the JAX kernel (in
interpret mode, as tests/test_kernels.py runs it) and through the port's
wrapper on CPU tensors, which runs the kernel's plain torch version.
Tolerances are those of the JAX package's own kernel tests, each with
its reason.  The CUDA kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import itertools
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels import decode_fused as jdf  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.outer_accum import outer_accum as joa  # noqa: E402
from repro.kernels.sr_matmul import sr_matmul as jmm  # noqa: E402
from repro.kernels.sr_round import sr_round as jround  # noqa: E402
from repro_torch.core.pmag import matmul_nest  # noqa: E402
from repro_torch.core.rounding import make_rbits, sr_cast_bf16  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_fused as kdf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import outer_accum as koa  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import sr_matmul as kmm  # noqa: E402
from repro_torch.kernels import sr_round as ksr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# f32 path (tests/test_kernels.py): another accumulation order, ~K ulp
MM_RTOL, MM_ATOL = 5e-4, 1e-4
# outer_accum f32 output (tests/test_kernels.py:75)
OA_RTOL, OA_ATOL = 1e-4, 1e-5
# y of the fused unit / cache entries (tests/test_decode_fused.py)
Y_TOL, CACHE_TOL = 2e-2, 6e-2


def bf16_pair(x: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    bits = np.asarray(jax.lax.bitcast_convert_type(j, jnp.uint16))
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return j, t


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bits16(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint16))


# ---------------------------------------------------------------------------
# sr_matmul
# ---------------------------------------------------------------------------

# (m, n, k): k=200 leaves a ragged tail of 8 under tk=64; m, n ragged too
MM_SHAPES = [(32, 96, 200), (37, 64, 128), (8, 130, 72)]


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("mnk", MM_SHAPES)
def test_sr_matmul_f32_path_matches_pallas(mnk, trans_b):
    m, n, k = mnk
    rng = np.random.default_rng(0)
    aj, at = bf16_pair(rng.standard_normal((m, k)))
    bj, bt = bf16_pair(rng.standard_normal((n, k) if trans_b else (k, n)))
    want = jmm(aj, bj, None, block=(64, 64, 64), interpret=True,
               trans_b=trans_b)
    got = kmm.sr_matmul(at, bt, trans_b=trans_b)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("mnk", MM_SHAPES)
def test_sr_matmul_sr_path_bit_exact_with_injected_rbits(mnk, trans_b):
    """The same rbits into both: bit-equal SR-bf16 outputs.  B has one
    nonzero per output column, so every f32 accumulator is one exact
    product (16 significant bits — the SR carries really happen) and the
    accumulation order cannot matter."""
    m, n, k = mnk
    rng = np.random.default_rng(1)
    b = np.zeros((k, n))
    b[rng.integers(0, k, size=n), np.arange(n)] = rng.standard_normal(n)
    aj, at = bf16_pair(rng.standard_normal((m, k)))
    bj, bt = bf16_pair(b.T.copy() if trans_b else b)
    rb = rng.integers(0, 2**32, size=(m, n), dtype=np.uint64).astype(np.uint32)
    want = jmm(aj, bj, jnp.asarray(rb), block=(64, 64, 64), interpret=True,
               trans_b=trans_b)
    got = kmm.sr_matmul(at, bt, torch.from_numpy(rb.view(np.int32)),
                        trans_b=trans_b)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits16(got), bits16(want))


def test_sr_matmul_sr_path_dense_within_one_step():
    """Dense operands: the f32 order may differ by an ulp, which SR turns
    into one bf16 step on a few elements (tests/test_kernels.py)."""
    rng = np.random.default_rng(2)
    aj, at = bf16_pair(rng.standard_normal((64, 192)))
    bj, bt = bf16_pair(rng.standard_normal((192, 96)))
    rb = rng.integers(0, 2**32, size=(64, 96), dtype=np.uint64).astype(np.uint32)
    want = jref.sr_matmul_ref(aj, bj, jnp.asarray(rb))
    got = ops.sr_matmul(at, bt, sr=True,
                        rbits=torch.from_numpy(rb.view(np.int32)))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1.2e-2)


EDGE = np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 1.0, -1.0,
                 np.float32(1.0) - np.float32(2**-24) * 2,   # carries up
                 3.4028235e38, -3.4028235e38, 1e-40, -1e-40, 65504.0,
                 np.float32(np.nextafter(np.float32(2.0), np.float32(0)))],
                np.float32)


@pytest.mark.parametrize("r", [0, 0xFFFF, 0x8000, 0xFFFFFFFF, 0x12345678])
def test_sr_epilogue_bit_exact_on_edge_values(r):
    rb = np.full(EDGE.shape, r, np.uint32)
    want = jref.sr_cast_bf16(jnp.asarray(EDGE), jnp.asarray(rb))
    got = sr_cast_bf16(torch.from_numpy(EDGE), torch.from_numpy(rb.view(np.int32)))
    np.testing.assert_array_equal(bits16(got), bits16(want))


@settings(deadline=None, max_examples=25)
@given(st.integers(0, 2**31 - 1))
def test_sr_epilogue_bit_exact_on_random_bit_patterns(seed):
    """Any f32 bit pattern (subnormals, NaN payloads, exponent carries)
    and any 32 random bits: the int32 epilogue equals the reference."""
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
    rb = rng.integers(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
    x = xb.view(np.float32)
    want = jref.sr_cast_bf16(jnp.asarray(x), jnp.asarray(rb))
    got = sr_cast_bf16(torch.from_numpy(x.copy()),
                       torch.from_numpy(rb.view(np.int32)))
    np.testing.assert_array_equal(bits16(got), bits16(want))


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_sr_epilogue_in_chunks_bit_exact(chunk, monkeypatch):
    """The plain SR cast rounds SR_CHUNK elements at a time: a (9, 17)
    tensor of random bit patterns and the edge values, in chunks that
    split its rows, equals the reference bit for bit."""
    from repro_torch.core import rounding
    monkeypatch.setattr(rounding, "SR_CHUNK", chunk)
    rng = np.random.default_rng(chunk)
    xb = rng.integers(0, 2**32, size=(9, 17), dtype=np.uint64)
    x = xb.astype(np.uint32).view(np.float32)
    x.reshape(-1)[:EDGE.size] = EDGE
    rb = rng.integers(0, 2**32, size=(9, 17), dtype=np.uint64) \
        .astype(np.uint32)
    want = jref.sr_cast_bf16(jnp.asarray(x), jnp.asarray(rb))
    got = sr_cast_bf16(torch.from_numpy(x.copy()),
                       torch.from_numpy(rb.view(np.int32)))
    assert got.shape == (9, 17) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits16(got), bits16(want))


def test_ops_sr_matmul_draws_rbits_from_the_generator():
    """sr=True without rbits draws them from the torch.Generator: the
    same as passing make_rbits of an identically seeded generator."""
    rng = np.random.default_rng(5)
    _, at = bf16_pair(rng.standard_normal((8, 40)))
    _, bt = bf16_pair(rng.standard_normal((40, 24)))
    got = ops.sr_matmul(at, bt, torch.Generator().manual_seed(9), sr=True)
    rb = make_rbits((8, 24), torch.Generator().manual_seed(9))
    assert torch.equal(got.view(torch.int16),
                       kref.sr_matmul_ref(at, bt, rb).view(torch.int16))


def test_make_rbits_lo_layout_matches_reference_rotation():
    """lo=True: one word per 256 elements, rotated by idx % 32 — the
    reference's layout, checked on the port's own words."""
    g = torch.Generator().manual_seed(3)
    r = make_rbits((3, 300), g, lo=True).reshape(-1).numpy().view(np.uint32)
    g = torch.Generator().manual_seed(3)
    words = torch.randint(0, 1 << 32, (4,), generator=g,
                          dtype=torch.int64).numpy().astype(np.uint32)
    idx = np.arange(900, dtype=np.uint32)
    w, rot = words[idx // 256], idx % 32
    want = (w >> rot) | (w << ((32 - rot) % 32))
    np.testing.assert_array_equal(r, want)


@pytest.mark.parametrize("mnk", [(32, 896, 4864), (37, 333, 1000), (1, 1, 1)])
def test_matmul_nest_matches_reference(mnk):
    from repro.core.pmag import matmul_nest as jnest
    m, n, k = mnk
    ours = matmul_nest(m, n, k, tm=32, tn=32, tk=64)
    theirs = jnest(m, n, k, tm=32, tn=32, tk=64)
    assert ours.grid == theirs.grid
    assert ours.launch_grid("j", "i") == (theirs.grid[1], theirs.grid[0])


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("mnk", MM_SHAPES)
def test_sr_matmul_f32_operands_match_pallas(mnk, trans_b):
    """The fp32 preset's operands: both packages take f32 A and B."""
    m, n, k = mnk
    rng = np.random.default_rng(6)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((n, k) if trans_b else (k, n)).astype(np.float32)
    want = jmm(jnp.asarray(a), jnp.asarray(b), None, block=(64, 64, 64),
               interpret=True, trans_b=trans_b)
    got = kmm.sr_matmul(torch.from_numpy(a), torch.from_numpy(b),
                        trans_b=trans_b)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_RTOL,
                               atol=MM_ATOL)


# ---------------------------------------------------------------------------
# outer_accum
# ---------------------------------------------------------------------------

# (t, d, f): divisible by the (32, 32, 64) tile, then ragged in T (the
# TPU kernel's t_rem tail), D and F
OA_SHAPES = [(128, 64, 96), (100, 48, 40), (37, 130, 72)]


@pytest.mark.parametrize("scale", [1.0, "1/T"])
@pytest.mark.parametrize("tdf", OA_SHAPES)
def test_outer_accum_f32_matches_ref_and_pallas(tdf, scale):
    t, d, f = tdf
    scale = 1.0 / t if scale == "1/T" else scale
    rng = np.random.default_rng(7)
    xj, xt = bf16_pair(rng.standard_normal((t, d)))
    yj, yt = bf16_pair(rng.standard_normal((t, f)))
    got = koa.outer_accum(xt, yt, scale=scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (d, f)
    for want in (jref.outer_accum_ref(xj, yj, scale=scale),
                 joa(xj, yj, scale=scale, block=(32, 32, 64),
                     interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=OA_RTOL, atol=OA_ATOL)


@pytest.mark.parametrize("tdf", OA_SHAPES)
def test_outer_accum_f32_operands_match_ref(tdf):
    t, d, f = tdf
    rng = np.random.default_rng(8)
    x = rng.standard_normal((t, d)).astype(np.float32)
    dy = rng.standard_normal((t, f)).astype(np.float32)
    got = kref.outer_accum_ref(torch.from_numpy(x), torch.from_numpy(dy),
                               scale=0.5)
    want = jref.outer_accum_ref(jnp.asarray(x), jnp.asarray(dy), scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OA_RTOL,
                               atol=OA_ATOL)


@pytest.mark.parametrize("scale", [1.0, "1/T"])
@pytest.mark.parametrize("tdf", OA_SHAPES)
def test_outer_accum_sr_bit_exact_with_injected_rbits(tdf, scale):
    """Injected rbits: bit-equal to outer_accum_ref and to the Pallas
    kernel.  dY has one nonzero per column, so every f32 accumulator is
    one exact product (the SR carries really happen) and the order of
    summation cannot matter."""
    t, d, f = tdf
    scale = 1.0 / t if scale == "1/T" else scale
    rng = np.random.default_rng(9)
    dy = np.zeros((t, f))
    dy[rng.integers(0, t, size=f), np.arange(f)] = rng.standard_normal(f)
    xj, xt = bf16_pair(rng.standard_normal((t, d)))
    yj, yt = bf16_pair(dy)
    rb = rng.integers(0, 2**32, size=(d, f), dtype=np.uint64).astype(np.uint32)
    got = ops.outer_accum(xt, yt, scale=scale, sr=True,
                          rbits=torch.from_numpy(rb.view(np.int32)))
    assert got.dtype == torch.bfloat16
    for want in (jref.outer_accum_ref(xj, yj, scale=scale,
                                      rbits=jnp.asarray(rb)),
                 joa(xj, yj, scale=scale, rbits=jnp.asarray(rb),
                     block=(32, 32, 64), interpret=True)):
        np.testing.assert_array_equal(bits16(got), bits16(want))


def test_ops_outer_accum_draws_rbits_from_the_generator():
    rng = np.random.default_rng(10)
    _, xt = bf16_pair(rng.standard_normal((16, 24)))
    _, yt = bf16_pair(rng.standard_normal((16, 40)))
    got = ops.outer_accum(xt, yt, torch.Generator().manual_seed(4), sr=True,
                          lo=True)
    rb = make_rbits((24, 40), torch.Generator().manual_seed(4), lo=True)
    assert torch.equal(got.view(torch.int16),
                       kref.outer_accum_ref(xt, yt, rbits=rb)
                       .view(torch.int16))


# ---------------------------------------------------------------------------
# sr_round
# ---------------------------------------------------------------------------

SR_EDGE = np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0,
                    1e-45, -1e-45, 1e-40, -1e-40, 1.1754942e-38,
                    3.4028235e38, -3.4028235e38, 3.3961776e38, 65504.0,
                    1.0, -1.0, 0.1], np.float32)


@pytest.mark.parametrize("r", [0, 0x7FFF, 0x8000, 0xFFFF, 0xFFFFFFFF,
                               0x89ABCDEF])
def test_sr_round_bit_exact_on_edge_values(r):
    """±inf, NaN, ±0, subnormals and the largest finite values (which
    carry into inf): the plain version equals the reference oracle and
    the Pallas kernel bit for bit."""
    x = np.tile(SR_EDGE, 8).reshape(8, -1)
    rb = np.full(x.shape, r, np.uint32)
    got = ksr.sr_round(torch.from_numpy(x), torch.from_numpy(rb.view(np.int32)))
    for want in (jref.sr_round_ref(jnp.asarray(x), jnp.asarray(rb)),
                 jround(jnp.asarray(x), jnp.asarray(rb), interpret=True)):
        np.testing.assert_array_equal(bits16(got), bits16(want))


@pytest.mark.parametrize("shape", [(64, 128), (3, 5, 7)])
def test_sr_round_bit_exact_on_random_bit_patterns(shape):
    rng = np.random.default_rng(11)
    n = int(np.prod(shape))
    x = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32) \
        .view(np.float32).reshape(shape)
    rb = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    got = ops.sr_round(torch.from_numpy(x.copy()),
                       rbits=torch.from_numpy(rb.view(np.int32)))
    want = jref.sr_round_ref(jnp.asarray(x), jnp.asarray(rb))
    np.testing.assert_array_equal(bits16(got), bits16(want))


# ---------------------------------------------------------------------------
# fused_attn_unit
# ---------------------------------------------------------------------------

FUSED_CASES = [
    dict(act="swiglu", norm="rmsnorm", window=None, with_ffn=True),
    dict(act="swiglu", norm="rmsnorm", window=5, with_ffn=True),
    dict(act="swiglu", norm="rmsnorm", window=None, with_ffn=False),
    dict(act="geglu", norm="layernorm", window=None, with_ffn=True),
    dict(act="gelu", norm="rmsnorm", window=None, with_ffn=True),
    dict(act="relu_sq", norm="layernorm", window=None, with_ffn=True),
]


def _fused_inputs(case, seed=0, B=2, S=16, d=64, H=4, K=2, hd=16, f=128):
    rng = np.random.default_rng(seed)
    qn = (H + 2 * K) * hd
    fin = 2 * f if case["act"] in ("swiglu", "geglu") else f
    w = {"qkv_w": rng.standard_normal((d, qn)) * d ** -0.5,
         "o_w": rng.standard_normal((H * hd, d)) * (H * hd) ** -0.5,
         "w_in": rng.standard_normal((d, fin)) * d ** -0.5,
         "w_out": rng.standard_normal((f, d)) * f ** -0.5}
    vec = {"norm1_scale": 1 + 0.3 * rng.standard_normal(d),
           "norm2_scale": 1 + 0.3 * rng.standard_normal(d),
           "qkv_bias": 0.3 * rng.standard_normal(qn)}
    if case["norm"] == "layernorm":
        vec["norm1_bias"] = 0.2 * rng.standard_normal(d)
        vec["norm2_bias"] = 0.2 * rng.standard_normal(d)
    fill = np.array([3, 9])
    ck = rng.standard_normal((B, S, K, hd))
    cv = rng.standard_normal((B, S, K, hd))
    cpos = np.where(np.arange(S)[None] < fill[:, None], np.arange(S)[None], -1)
    xs = [rng.standard_normal((B, d)) for _ in range(3)]
    return dict(w=w, vec=vec, fill=fill, ck=ck, cv=cv, cpos=cpos, xs=xs,
                dims=dict(heads=H, kv_heads=K, head_dim=hd))


@pytest.mark.parametrize("case", FUSED_CASES,
                         ids=lambda c: f"{c['act']}-{c['norm']}-w{c['window']}"
                                       f"-ffn{int(c['with_ffn'])}")
def test_fused_attn_unit_matches_pallas_over_three_steps(case):
    inp = _fused_inputs(case)
    kw = dict(**inp["dims"], rope_theta=1e4, window=case["window"],
              norm_kind=case["norm"], act=case["act"], block_n=32,
              with_ffn=case["with_ffn"])
    jw = {k: bf16_pair(v)[0] for k, v in inp["w"].items()}
    tw = {k: bf16_pair(v)[1] for k, v in inp["w"].items()}
    jv = {k: jnp.asarray(v, jnp.float32) for k, v in inp["vec"].items()}
    jv.setdefault("norm1_bias", None)
    tv = {k: torch.from_numpy(v.astype(np.float32)) for k, v in inp["vec"].items()}
    if not case["with_ffn"]:
        for d_ in (jw, tw):
            d_.pop("w_in")
            d_.pop("w_out")
    jc = [bf16_pair(inp["ck"])[0], bf16_pair(inp["cv"])[0],
          jnp.asarray(inp["cpos"], jnp.int32)]
    tc = [bf16_pair(inp["ck"])[1], bf16_pair(inp["cv"])[1],
          torch.from_numpy(inp["cpos"].astype(np.int32))]
    # one trace for the three steps (statics bound, arrays traced)
    jfn = jax.jit(lambda *a, **arrs: jdf.fused_attn_unit(
        *a, **arrs, **kw, interpret=True))
    for t, x in enumerate(inp["xs"]):
        pos = (inp["fill"] + t).astype(np.int32)
        xj, xt = bf16_pair(x)
        yj, *jc = jfn(xj, *jc, jnp.asarray(pos), **jw, **jv)
        yt = kdf.fused_attn_unit(xt, *tc, torch.from_numpy(pos), **tw, **tv,
                                 **kw)
        np.testing.assert_allclose(to_np(yt), to_np(yj), atol=Y_TOL,
                                   rtol=Y_TOL)
    for a, b in zip(tc[:2], jc[:2]):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=CACHE_TOL,
                                   rtol=CACHE_TOL)
    np.testing.assert_array_equal(tc[2].numpy(), np.asarray(jc[2]))


def test_fused_attn_unit_leaves_inactive_rows_untouched():
    case = FUSED_CASES[0]
    inp = _fused_inputs(case, seed=4)
    tw = {k: bf16_pair(v)[1] for k, v in inp["w"].items()}
    tv = {k: torch.from_numpy(v.astype(np.float32)) for k, v in inp["vec"].items()}
    tc = [bf16_pair(inp["ck"])[1], bf16_pair(inp["cv"])[1],
          torch.from_numpy(inp["cpos"].astype(np.int32))]
    before = [c.clone() for c in tc]
    active = torch.tensor([False, True])
    kdf.fused_attn_unit(bf16_pair(inp["xs"][0])[1], *tc,
                        torch.from_numpy(inp["fill"].astype(np.int32)),
                        **tw, **tv, **inp["dims"], rope_theta=1e4,
                        active=active)
    for a, b in zip(tc, before):
        assert torch.equal(a[0], b[0])          # inactive row: bit-identical
        assert not torch.equal(a[1], b[1])      # active row: appended


@pytest.mark.parametrize("kv_split", [24, 64, 7, 1])
def test_split_kv_combine_matches_pallas(kv_split):
    """The kernel's attention split over the cache positions (per split
    m_i, l_i, o_i, merged in split order), emulated in plain torch by
    fused_attn_unit_plain(kv_split=...), against JAX's fused_attn_unit in
    interpret mode over three steps: S = 24, a window of 5 (whole splits
    of 7 and of 1 masked), row 0 inactive."""
    case = dict(act="swiglu", norm="rmsnorm", window=5, with_ffn=True)
    inp = _fused_inputs(case, seed=6, S=24)
    dims = inp["dims"]
    kw = dict(**dims, rope_theta=1e4, window=5, norm_kind="rmsnorm",
              act="swiglu")
    jw = {k: bf16_pair(v)[0] for k, v in inp["w"].items()}
    tw = {k: bf16_pair(v)[1] for k, v in inp["w"].items()}
    jv = {k: jnp.asarray(v, jnp.float32) for k, v in inp["vec"].items()}
    jv.setdefault("norm1_bias", None)
    tv = {k: torch.from_numpy(v.astype(np.float32))
          for k, v in inp["vec"].items()}
    jc = [bf16_pair(inp["ck"])[0], bf16_pair(inp["cv"])[0],
          jnp.asarray(inp["cpos"], jnp.int32)]
    tc = [bf16_pair(inp["ck"])[1], bf16_pair(inp["cv"])[1],
          torch.from_numpy(inp["cpos"].astype(np.int32))]
    before = [c.clone() for c in tc]
    jfn = jax.jit(lambda *a, **arrs: jdf.fused_attn_unit(
        *a, **arrs, **kw, block_n=32, with_ffn=True, interpret=True))
    d = inp["xs"][0].shape[1]
    zeros = torch.zeros(d)
    active = torch.tensor([False, True])
    for t, x in enumerate(inp["xs"]):
        pos = (inp["fill"] + t).astype(np.int32)
        xj, xt = bf16_pair(x)
        yj, *jc = jfn(xj, *jc, jnp.asarray(pos), **jw, **jv)
        yt = kdf.fused_attn_unit_plain(
            xt, *tc, torch.from_numpy(pos), n1s=tv["norm1_scale"], n1b=zeros,
            qkv_w=tw["qkv_w"], qkv_b=tv["qkv_bias"], o_w=tw["o_w"],
            n2s=tv["norm2_scale"], n2b=zeros, w_in=tw["w_in"],
            w_out=tw["w_out"], tn=32, with_ffn=True, active=active,
            kv_split=kv_split, **kw)
        # row 0 keeps its cache, so after step 0 it attends to another
        # cache than JAX's (which appends every row); its y is discarded
        rows = slice(0, 2) if t == 0 else slice(1, 2)
        np.testing.assert_allclose(to_np(yt)[rows], to_np(yj)[rows],
                                   atol=Y_TOL, rtol=Y_TOL)
    for a, b in zip(tc[:2], jc[:2]):
        np.testing.assert_allclose(to_np(a)[1], to_np(b)[1], atol=CACHE_TOL,
                                   rtol=CACHE_TOL)
    np.testing.assert_array_equal(tc[2].numpy()[1], np.asarray(jc[2])[1])
    for a, b in zip(tc, before):
        assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("kv_split", [1, 5, 16, 64])
def test_split_kv_merge_gives_zero_weight_to_masked_splits(kv_split):
    """A split with no valid position (m_i = -1e30, l_i = its count)
    contributes exactly nothing; the merge equals one softmax."""
    g = torch.Generator().manual_seed(3)
    B, S, K, G, hd = 3, 40, 2, 3, 16
    q = torch.randn((B, K, G, hd), generator=g)
    kc = torch.randn((B, S, K, hd), generator=g).bfloat16()
    vc = torch.randn((B, S, K, hd), generator=g).bfloat16()
    valid = torch.zeros((B, S), dtype=torch.bool)
    valid[0, :3] = True                 # every later split masked
    valid[1, 17:23] = True              # a window in the middle
    valid[2, 39] = True                 # the last position only
    want = kdf._attend(q, kc, vc, valid, 0.25, None)
    got = kdf._attend(q, kc, vc, valid, 0.25, kv_split)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # a masked split's weight exp(-1e30 - m) is exactly zero
    assert torch.exp(torch.tensor(kdf.NEG_INF) - torch.tensor(3.0)) == 0


# ---------------------------------------------------------------------------
# decode_plan: the launches, splits and workspace of the fused words
# ---------------------------------------------------------------------------

# the decode shapes of the served models and of the next dense config
DECODE_SHAPES = {
    "qwen2-0.5b": dict(d=896, f=4864, gated=True, heads=14, kv_heads=2,
                       head_dim=64, S=528),
    "rwkv6-1.6b": dict(d=2048, f=7168, gated=False, attention=False),
    "olmo-1b": dict(d=2048, f=8192, gated=True, heads=16, kv_heads=16,
                    head_dim=128, S=528)}


@pytest.mark.parametrize("arch", DECODE_SHAPES)
def test_decode_plan_splits_depend_on_n_k_only_and_fill_split_blocks(arch):
    """Every product of a word runs at least SPLIT_BLOCKS blocks (3/4 of
    the H100's 132 SMs) with splits that depend on (n, k) alone and
    partition K exactly."""
    plans = [kdf.decode_plan(B, **DECODE_SHAPES[arch]) for B in (1, 5, 32,
                                                                 100)]
    assert len({tuple(p.products.items()) for p in plans}) == 1
    assert len({p.attn_nsplit for p in plans}) == 1
    for gp in plans[2].products.values():
        assert gp == kdf.gemm_plan(gp.n, gp.k, gp.boxes)
        assert gp.blocks(32) >= kdf.SPLIT_BLOCKS
        ranges = gp.k_ranges()
        assert len(ranges) == gp.splits
        assert ranges[0][0] == 0 and ranges[-1][1] == gp.k
        for (_, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0                      # disjoint, no gap
        assert all(k0 < k1 and k0 % kdf.GEMM_BK == 0 for k0, k1 in ranges)


@pytest.mark.parametrize("n,k", [(1152, 896), (896, 896), (4864, 896),
                                 (896, 4864), (2048, 7168), (72, 200),
                                 (8, 8)])
def test_gemm_plan_k_partition_covers_k(n, k):
    gp = kdf.gemm_plan(n, k)
    got = [k for k0, k1 in gp.k_ranges() for k in range(k0, k1)]
    assert got == list(range(k))
    assert 1 <= gp.splits <= math.ceil(k / kdf.GEMM_BK)


@pytest.mark.parametrize("arch", DECODE_SHAPES)
@pytest.mark.parametrize("B", [5, 32])
def test_decode_layout_matches_the_kernel_and_does_not_overlap(arch, B):
    src = (build.CSRC / "decode_fused.cu").read_text()
    fields = re.search(r"enum Layout \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in fields.split(",") if n.strip()]
    assert names[-1] == "L_FIELDS"
    assert [n[2:].lower() for n in names[:-1]] == list(kdf.LAYOUT_FIELDS)
    sh = DECODE_SHAPES[arch]
    p = kdf.decode_plan(B, **sh)
    lay = p.layout
    d, f = sh["d"], sh["f"]
    H, K, hd = sh.get("heads", 0), sh.get("kv_heads", 0), sh.get("head_dim",
                                                                   0)
    att = sh.get("attention", True)
    need = {"h1": 2 * B * d * att, "o": 2 * B * H * hd,
            "x1": 2 * B * d * att, "h2": 2 * B * d, "h": 2 * B * f,
            "attn": 4 * B * K * p.attn_nsplit * kdf._part_stride(
                H // max(K, 1), hd),
            "part": max(4 * g.splits * B * g.boxes * g.n
                        for n, g in p.products.items()
                        if g.splits > 1 or n in kdf.RAW_PRODUCTS),
            "cnt": 4 * lay["n_cnt"]}
    keys = list(need)
    for a, b in zip(keys, keys[1:] + [None]):
        end = p.ws_bytes if b is None else lay[b]
        assert lay[a] % 256 == 0 and end - lay[a] >= need[a]
    counts = {"cnt_in": "ffn_in", "cnt_out": "ffn_out"}
    spans = [(lay[c], p.products[n].tiles * math.ceil(B / 64))
             for c, n in counts.items() if p.products[n].splits > 1]
    if p.attn_nsplit > 1:
        spans.append((lay["cnt_attn"], B * K))
    spans.sort()
    for (a0, an), (b0, _) in zip(spans, spans[1:]):
        assert a0 + an <= b0
    if spans:
        assert spans[-1][0] + spans[-1][1] <= lay["n_cnt"]
    assert p.launches == (7 if att else 3)
    assert list(p.args) == [lay[k] for k in kdf.LAYOUT_FIELDS]


def test_decode_entries_count_each_launch_they_make():
    """The C entries report their launches through a last `int*
    launched`, and every kernel launch of the file goes through the one
    helper that adds to it once the launch is made."""
    src = (build.CSRC / "decode_fused.cu").read_text()
    for entry in ("fused_attn_unit_bf16", "fused_ffn_bf16"):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
        assert sig.split(",")[-1].split() == ["int*", "launched"]
    assert "<<<" not in src and src.count("cudaLaunchKernelEx(") == 1
    helper = src[src.index("cudaLaunchKernelEx("):]
    assert re.match(r"[^;]*;\s*const int err = [^;]*;\s*if \(err == 0\) "
                    r"\+\+\*launched;", helper)


@pytest.mark.parametrize("variant", ["base", "r1", "r4", "r7", "nocompute",
                                     "noprefetch", "noqkvsum", "stages4",
                                     "merge2"])
def test_decode_variants_edit_the_current_source(variant):
    """launch/decode_variants.py finds the lines it edits in today's
    csrc/decode_fused.cu (a variant whose anchor moved raises)."""
    from repro_torch.launch import decode_variants as dv
    src = (build.CSRC / "decode_fused.cu").read_text()
    got = dv.edit(src, variant)
    assert (got == src) == (variant == "base")


# ---------------------------------------------------------------------------
# No fallback, and the package boundary
# ---------------------------------------------------------------------------


def test_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """A tensor that is not on the CPU never takes the plain version:
    the wrapper launches its kernel or raises."""
    a = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    b = torch.empty((8, 4), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="operands on"):
        kmm.sr_matmul(a, b)
    with pytest.raises(ValueError, match="operands on"):
        koa.outer_accum(a.t(), b)
    with pytest.raises(ValueError, match="tensors on meta"):
        ksr.sr_round(torch.empty((4, 8), device="meta"),
                     torch.empty((4, 8), dtype=torch.int32, device="meta"))
    inp = _fused_inputs(FUSED_CASES[0])
    tw = {k: bf16_pair(v)[1].to("meta") for k, v in inp["w"].items()}
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="tensors on meta"):
        kdf.fused_attn_unit(meta(2, 64), meta(2, 16, 2, 16), meta(2, 16, 2, 16),
                            torch.empty((2, 16), dtype=torch.int32,
                                        device="meta"),
                            torch.zeros(2, dtype=torch.int32, device="meta"),
                            **tw, qkv_bias=None, heads=4, kv_heads=2,
                            head_dim=16, rope_theta=1e4)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(("sr_matmul",))


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:[.\s]|$)")


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if _IMPORT.match(line)]
    assert bad == []


def test_launch_counters_count_only_kernel_launches():
    counters = (kmm.COUNTER, kdf.COUNTER, koa.COUNTER, ksr.COUNTER,
                *kmm.PATH_COUNTERS.values(), *koa.PATH_COUNTERS.values())
    for c in counters:
        c.reset()
    kmm.sr_matmul(torch.ones(2, 3, dtype=torch.bfloat16),
                  torch.ones(3, 2, dtype=torch.bfloat16))
    koa.outer_accum(torch.ones(2, 3), torch.ones(2, 4))
    ksr.sr_round(torch.ones(2, 3), torch.zeros(2, 3, dtype=torch.int32))
    assert [c.n for c in counters] == [0] * len(counters)  # plain versions ran


# ---------------------------------------------------------------------------
# The build digest, and the sm90 / generic plan of the bf16 products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("header", ["gemm_sm90.cuh", "common.cuh"])
def test_build_digest_changes_with_every_header(monkeypatch, tmp_path,
                                                header):
    """A changed shared header renames every library, so a stale .so is
    never loaded; a change to another kernel's source renames none."""
    import shutil
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src, ignore=shutil.ignore_patterns("_build"))
    monkeypatch.setattr(build, "CSRC", src)
    before = {n: build._digest(n) for n in ("sr_matmul", "outer_accum")}
    (src / "wkv6.cu").write_text((src / "wkv6.cu").read_text() + "\n// x\n")
    assert {n: build._digest(n) for n in before} == before
    (src / header).write_text((src / header).read_text() + "\n// x\n")
    after = {n: build._digest(n) for n in before}
    assert all(after[n] != before[n] for n in before)


def _main_path_products(arch: str) -> list:
    """(id, m, n, k, a_major, b_major, lda, ldb, rows_invariant) of every
    bf16 product on `arch`'s main paths, from the port's config: PREFILL
    at a 32-token chunk; for qwen2 also training's FF, BP (T = 1024 rows,
    the tied head per 256-row loss chunk) and UP (outer_accum: A = X^T)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    out = []
    if arch == "rwkv6-1.6b":
        # W (P, Q) with its row stride: the four rkvg quarters are column
        # views of the (d, 4d) table
        ws = [(f"rkvg[{i}]", d, d, 4 * d) for i in range(4)]
        ws += [("decay", d, d, d), ("o", d, d, d), ("ffn_in", d, f, f),
               ("ffn_out", f, d, d), ("lm_head", d, V, V)]
        return [(f"{arch}:prefill:{n}", 32, q, p, "k", "n", p, ld, True)
                for n, p, q, ld in ws]
    a = cfg.attention
    qkv = (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
    ws = [("qkv", d, qkv), ("o", a.n_heads * a.head_dim, d),
          ("ffn_in", d, 2 * f), ("ffn_out", f, d)]
    T = 1024
    for n, p, q in ws:
        out += [(f"{arch}:prefill:{n}", 32, q, p, "k", "n", p, q, True),
                (f"{arch}:ff:{n}", T, q, p, "k", "n", p, q, True),
                (f"{arch}:bp:{n}", T, p, q, "k", "k", q, q, True),
                (f"{arch}:up:{n}", p, q, T, "m", "n", p, q, False)]
    # the tied head: logits x . table^T, dX = g . table, dTable = g^T x
    out += [(f"{arch}:prefill:head", 32, V, d, "k", "k", d, d, True),
            (f"{arch}:ff:head", T // 4, V, d, "k", "k", d, d, True),
            (f"{arch}:bp:head", T // 4, d, V, "k", "n", V, d, True),
            (f"{arch}:up:head", V, d, T // 4, "m", "n", V, d, False)]
    return out


MAIN_PRODUCTS = (_main_path_products("qwen2-0.5b")
                 + _main_path_products("rwkv6-1.6b"))


@pytest.mark.parametrize("case", MAIN_PRODUCTS, ids=lambda c: c[0])
def test_main_path_products_take_the_sm90_path(case):
    _, m, n, k, am, bm_, lda, ldb, inv = case
    p = kmm.plan(m, n, k, am, bm_, lda=lda, ldb=ldb, rows_invariant=inv)
    assert p.path == "sm90" and p.bk == 64 and p.bm == 128
    x, y, z = p.grid(m, n, k)
    assert z == p.splits >= 1 and x * y >= 1


@pytest.mark.parametrize("case", [
    dict(m=37, n=333, k=1000, b="n", ldb=333),      # B's row: 666 bytes
    dict(m=37, n=333, k=1000, b="k", lda=1001),     # A's row stride
    dict(m=32, n=896, k=4864, b="n", aligned=False),  # base not 16-aligned
], ids=["b-row-666B", "a-stride-odd", "unaligned-base"])
def test_unaligned_operands_take_the_generic_path(case):
    c = dict(case)
    m, n, k, b = c.pop("m"), c.pop("n"), c.pop("k"), c.pop("b")
    p = kmm.plan(m, n, k, "k", b, **c)
    assert p == kmm.Plan("generic", *kmm.TILE, 1)


PLAN_NK = [(896, 151936, "n"), (896, 4864, "n"), (896, 9728, "k"),
           (1152, 896, "n"), (151936, 896, "k"), (2048, 7168, "n"),
           (333, 1000, "k"), (64, 200, "n"), (8, 8, "k"), (96, 1, "n")]
# (m, n, k) of f32 products: a training step's FF, BP and UP under the
# fp32 preset (the head's BP at 256 and at 32 rows), then ragged shapes
F32_MNK = [(1024, 1152, 896), (1024, 896, 896), (1024, 9728, 896),
           (1024, 896, 4864), (256, 151936, 896), (1024, 896, 9728),
           (256, 896, 151936), (32, 896, 151936), (896, 896, 1024),
           (151936, 896, 256), (37, 333, 1000), (5, 36, 4100), (1, 1, 1),
           (130, 1, 17)]


@pytest.mark.parametrize("m,n,k,b_major,f32", [
    *(pytest.param(32, n, k, b, False, id=f"{n}-{k}-{b}")
      for n, k, b in PLAN_NK),
    *(pytest.param(m, n, k, "n", True, id=f"f32-{m}-{n}-{k}")
      for m, n, k in F32_MNK)])
def test_plan_k_partition_is_disjoint_and_covers_k(m, n, k, b_major, f32):
    p = kmm.plan(m, n, k, "k", b_major, f32=f32)
    assert (p.path == "f32") == f32
    ranges = p.k_ranges(k)
    assert len(ranges) == p.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0                       # disjoint, no gap
    for k0, k1 in ranges:
        assert k0 < k1                        # no empty split
        assert k0 % p.bk == 0 and (k1 % p.bk == 0 or k1 == k)


@pytest.mark.parametrize("n,k,b_major", PLAN_NK)
def test_plan_does_not_depend_on_m(n, k, b_major):
    plans = {kmm.plan(m, n, k, "k", b_major) for m in (1, 5, 32, 256, 1024)}
    assert len(plans) == 1


def _mnk_id(c) -> str:
    return "x".join(map(str, c))


@pytest.mark.parametrize("mnk", F32_MNK, ids=_mnk_id)
def test_f32_plan_depends_on_the_shape_alone(mnk):
    """An f32 plan comes from (M, N, K) alone: not from the operands'
    majorness, strides, alignment or row invariance, nor from the
    device; its grid is the reference's loop nest over its tiles."""
    from repro.core.pmag import matmul_nest as jnest
    m, n, k = mnk
    plans = {kmm.plan(m, n, k, am, bm_, lda=lda, ldb=ldb, aligned=al,
                      rows_invariant=ri, f32=True)
             for am in ("k", "m") for bm_ in ("k", "n")
             for lda, ldb in ((None, None), (k + 3, n + 5))
             for al in (True, False) for ri in (True, False)}
    assert plans == {kmm.f32_plan(m, n, k)}
    p = kmm.f32_plan(m, n, k)
    assert p.path == "f32" and (p.bm, p.bn, p.bk) == kmm.F32_TILE
    theirs = jnest(m, n, k, tm=p.bm, tn=p.bn, tk=p.bk)
    assert p.grid(m, n, k) == (theirs.grid[1], theirs.grid[0], p.splits)
    meta = lambda *shape: torch.empty(shape, device="meta")
    assert koa.up_plan(meta(k, m), meta(k, n)) == p


@pytest.mark.parametrize("mnk", [c for c in F32_MNK
                                 if kmm.f32_plan(*c).splits > 1],
                         ids=_mnk_id)
def test_f32_split_workspace_does_not_overlap_the_output(mnk):
    """The f32 split-K workspace: splits x M x N f32 partials, then one
    zeroed int32 counter per output tile, in one allocation apart from
    the output; no workspace without splits."""
    m, n, k = mnk
    p = kmm.f32_plan(m, n, k)
    out = torch.empty((m, n))
    ws = kmm.split_workspace(p, m, n, "cpu")
    gx, gy, splits = p.grid(m, n, k)
    parts = ws[:splits * m * n]
    counters = ws[splits * m * n:].view(torch.int32)
    assert counters.numel() == gx * gy and bool((counters == 0).all())

    def span(t):
        return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()

    (p0, p1), (c0, c1), (o0, o1) = span(parts), span(counters), span(out)
    assert p1 == c0                               # counters right after
    assert c1 <= o0 or o1 <= p0                   # the output elsewhere
    assert kmm.split_workspace(kmm.f32_plan(1, 1, 1), 1, 1, "cpu") is None


def test_plan_splits_fill_the_card_at_the_narrow_products():
    """The tied head's BP and qwen2's PREFILL ffn_out are 896 wide: the
    split count brings them towards the 132 SMs without a second,
    part-filled wave of blocks (the head's 151936-deep reduction fills
    the card at 128-wide tiles, ffn_out's takes 64-wide ones)."""
    head_bp = kmm.plan(256, 896, 151936, "k", "n")
    ffn_out = kmm.plan(32, 896, 4864, "k", "n")
    assert (head_bp.bn, ffn_out.bn) == (128, 64)
    assert 8 <= head_bp.splits and 7 * head_bp.splits <= kmm.SMS
    assert ffn_out.splits > 1 and 14 * ffn_out.splits <= kmm.SMS


@pytest.mark.parametrize("mnk", [(32, 896, 4864), (256, 896, 151936),
                                 (1024, 1152, 896), (37, 333, 1000),
                                 (5, 64, 8)])
def test_plan_grid_matches_reference_nest(mnk):
    from repro.core.pmag import matmul_nest as jnest
    m, n, k = mnk
    p = kmm.plan(m, n, k, "k", "n")
    theirs = jnest(m, n, k, tm=p.bm, tn=p.bn, tk=p.bk)
    assert p.grid(m, n, k) == (theirs.grid[1], theirs.grid[0], p.splits)


@pytest.mark.parametrize("quarter", range(4))
def test_sr_matmul_on_rkvg_column_view_matches_copy_and_pallas(quarter):
    """rwkv6's r, k, v, g products read a column quarter of the fused
    (d, 4d) table in place: the view is taken as it lies (no copy), and
    gives what its contiguous copy and JAX's kernel give."""
    d, m = 64, 24
    rng = np.random.default_rng(7 + quarter)
    aj, at = bf16_pair(rng.standard_normal((m, d)))
    wj, wt = bf16_pair(rng.standard_normal((d, 4 * d)) * d ** -0.5)
    view = wt[:, quarter * d:(quarter + 1) * d]
    assert not view.is_contiguous() and kmm.operand(view) is view
    assert kmm.plan(m, d, d, "k", "n", ldb=kmm.row_stride(view)).path \
        == "sm90"
    got = kmm.sr_matmul(at, kmm.operand(view))
    np.testing.assert_array_equal(got.numpy(),
                                  kmm.sr_matmul(at, view.contiguous()).numpy())
    want = jmm(aj, wj[:, quarter * d:(quarter + 1) * d], None,
               block=(64, 64, 64), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_RTOL,
                               atol=MM_ATOL)
    tt = wt.t()                                 # a transpose is copied
    assert kmm.operand(tt) is not tt and kmm.operand(tt).is_contiguous()


# ---------------------------------------------------------------------------
# The f32 batched mode: a MoE expert table's products under the fp32 preset
# ---------------------------------------------------------------------------

# (experts, C, K, N) of granite-moe-1b-a400m's three tables (gate and up
# (32, 1024, 512), down (32, 512, 1024)) in each role: FF (C, K) . (K,
# N), BP (C, N) . (K, N)^T, UP (K, C) . (C, N) as (M, N, K)
GRANITE_F32 = [(32, m, n, k) for c in (1024, 8, 40)
               for m, n, k in ((c, 512, 1024), (c, 1024, 512))]


@pytest.mark.parametrize("emnk", GRANITE_F32, ids=_mnk_id)
def test_f32_batched_plan_depends_on_the_shape_and_experts_alone(emnk):
    """The f32 batched plan comes from (M, N, K, E) alone, whatever the
    operands' majorness, strides or alignment; its waves count every
    expert's tiles: granite's tables at C = 1024 give 1024 or 2048
    blocks and no split, a C = 8 product with 128 blocks (half a wave)
    splits K."""
    e, m, n, k = emnk
    plans = {kmm.plan(m, n, k, am, bm_, lda=lda, ldb=ldb, aligned=al,
                      rows_invariant=ri, f32=True, experts=e)
             for am in ("k", "m") for bm_ in ("k", "n")
             for lda, ldb in ((None, None), (k + 3, n + 5))
             for al in (True, False) for ri in (True, False)}
    p = kmm.f32_plan(m, n, k, experts=e)
    assert plans == {p} and p.path == "f32"
    gx, gy, splits = p.grid(m, n, k)
    blocks = gx * gy * e
    if m == 1024:
        assert blocks in (1024, 2048) and splits == 1
    if blocks < kmm.SMS * kmm.F32_OCC // 2 + 1:
        assert splits > 1 and blocks * splits <= kmm.SMS * kmm.F32_OCC
    assert koa.batched_f32_plan(e, k, m, n) == p
    assert kmm.f32_plan(m, n, k, experts=1) == kmm.f32_plan(m, n, k)


@pytest.mark.parametrize("emnk", [(32, 8, 512, 1024), (32, 40, 512, 1024),
                                  (3, 37, 72, 2000)], ids=_mnk_id)
def test_f32_batched_split_workspace_holds_every_experts_partials(emnk):
    """splits x E x M x N f32 partials, then E x grid_x x grid_y zeroed
    int32 counters, in one allocation: splits x E x M x N x 4 bytes plus
    the counters."""
    e, m, n, k = emnk
    p = kmm.f32_plan(m, n, k, experts=e)
    assert p.splits > 1
    gx, gy, splits = p.grid(m, n, k)
    ws = kmm.split_workspace(p, m, n, "cpu", experts=e)
    parts = splits * e * m * n
    assert ws.dtype == torch.float32
    assert ws.numel() * 4 == parts * 4 + e * gx * gy * 4
    assert bool((ws[parts:].view(torch.int32) == 0).all())
    assert kmm.split_workspace(kmm.f32_plan(1024, 512, 1024, experts=32),
                               1024, 512, "cpu", experts=32) is None


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("emnk", [(4, 8, 96, 64), (3, 37, 64, 200),
                                  (2, 5, 130, 72)], ids=_mnk_id)
def test_sr_matmul_batched_f32_plain_matches_vmapped_pallas(emnk, trans_b):
    """FF and BP (trans_b) of an f32 expert table: the batched plain
    version against jax.vmap of the reference's sr_matmul in interpret
    mode, at ragged C and K, within the f32 path's tolerance."""
    e, m, n, k = emnk
    rng = np.random.default_rng(61)
    a = rng.standard_normal((e, m, k)).astype(np.float32)
    b = (rng.standard_normal((e, n, k) if trans_b else (e, k, n))
         * k ** -0.5).astype(np.float32)
    want = jax.vmap(lambda x, y: jmm(x, y, None, block=(64, 64, 64),
                                     interpret=True, trans_b=trans_b))(
        jnp.asarray(a), jnp.asarray(b))
    got = kmm.sr_matmul_batched(torch.from_numpy(a), torch.from_numpy(b),
                                trans_b=trans_b)
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_RTOL,
                               atol=MM_ATOL)


@pytest.mark.parametrize("scale", [1.0, "1/T"])
@pytest.mark.parametrize("etdf", [(4, 12, 64, 32), (3, 37, 32, 64),
                                  (2, 130, 72, 40)], ids=_mnk_id)
def test_outer_accum_batched_f32_plain_matches_vmapped_pallas(etdf, scale):
    """UP of an f32 expert table (no SR: an f32 weight is not rounded):
    the batched plain version with its scale against jax.vmap of the
    reference's outer_accum in interpret mode, at a ragged token count,
    within outer_accum's f32 tolerance."""
    e, t, d, f = etdf
    scale = 1.0 / t if scale == "1/T" else scale
    rng = np.random.default_rng(62)
    x = rng.standard_normal((e, t, d)).astype(np.float32)
    dy = rng.standard_normal((e, t, f)).astype(np.float32)
    want = jax.vmap(lambda a, b: joa(a, b, scale=scale, block=(32, 32, 64),
                                     interpret=True))(jnp.asarray(x),
                                                      jnp.asarray(dy))
    got = koa.outer_accum_batched(torch.from_numpy(x), torch.from_numpy(dy),
                                  scale=scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, d, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OA_RTOL,
                               atol=OA_ATOL)


@given(e=st.integers(1, 40), m=st.integers(1, 700), n=st.integers(1, 600),
       k=st.integers(1, 3000), a_major=st.sampled_from("km"),
       live=st.integers(-2, 3002))
@settings(max_examples=60, deadline=None, derandomize=True)
def test_f32_batched_plan_and_units_cover_every_tile_and_k_block(
        e, m, n, k, a_major, live):
    """The f32 batched plan comes from (M, N, K, E) alone, and its units
    (one split of one expert's output tile each: the blocks of
    csrc/sgemm_sm90_batched.cuh's grid) cover every output tile, their
    splits every k-block of K once with none empty; cut at a live count
    (the UP's tokens), the splits' k-blocks are exactly the live ones.
    How the kernel numbers the units and skips the dead ones is held on
    the card (tests/test_torch_cuda.py)."""
    p = kmm.f32_plan(m, n, k, experts=e)
    assert p == kmm.plan(m, n, k, a_major, "n", lda=k + 1, aligned=False,
                         f32=True, experts=e)
    gx, gy, splits = p.grid(m, n, k)
    assert (gx - 1) * p.bn < n <= gx * p.bn and (gy - 1) * p.bm < m <= gy * p.bm
    assert e * gx * gy * splits < 2 ** 31
    kb, per = math.ceil(k / p.bk), p.kb_per_split(k)
    assert (splits - 1) * per < kb <= splits * per
    ranges = [range(z * per, min(kb, (z + 1) * per)) for z in range(splits)]
    assert all(ranges) and list(itertools.chain(*ranges)) == list(range(kb))
    live_kb = math.ceil(min(max(live, 0), k) / p.bk)
    cut = [range(z * per, z * per + max(0, min(per, live_kb - z * per)))
           for z in range(splits)]
    assert list(itertools.chain(*cut)) == list(range(live_kb))


def _dispatched_f32(counts, C, widths, seed):
    """(E, C, w) f32 buffers built by the port's MoE dispatch
    (models/moe.py) for experts with `counts` routed entries, each
    expert's rows past its count zero, and rows from _expert_rows."""
    from repro_torch.models import moe
    rng = np.random.default_rng(seed)
    E = len(counts)
    experts = torch.from_numpy(rng.permutation(np.repeat(np.arange(E),
                                                          counts)))
    slot, keep = moe._dispatch_indices(experts, E, C)
    rows = moe._expert_rows(experts, E, C)
    assert rows.tolist() == list(counts)
    bufs = []
    for w in widths:
        src = torch.from_numpy(rng.standard_normal((experts.numel(), w),
                                                   np.float32))
        buf = torch.zeros((E * C + 1, w))
        buf.index_copy_(0, slot, src * keep[:, None])
        bufs.append(buf[:-1].reshape(E, C, w))
    return bufs, rows


@pytest.mark.parametrize("role", ["ff", "bp", "up"])
def test_f32_batched_plain_with_live_rows_matches_vmapped_pallas(role):
    """The f32 batched plain versions with each expert's live rows, on
    buffers built by the port's dispatch (counts 0, 1, 15, 17, 40 of C =
    40): FF and BP against jax.vmap of the reference's sr_matmul, UP
    against jax.vmap of its outer_accum (interpret mode, every row: the
    dead ones are zero), within the f32 path's tolerances."""
    C, k, n = 40, 72, 48
    counts = (0, 1, 15, 17, 40)
    if role == "up":
        (x, dy), rows = _dispatched_f32(counts, C, [k, n], seed=63)
        want = jax.vmap(lambda a, b: joa(a, b, scale=0.5, block=(32, 32, 64),
                                         interpret=True))(
            jnp.asarray(x.numpy()), jnp.asarray(dy.numpy()))
        got = koa.outer_accum_batched(x, dy, scale=0.5, rows=rows)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=OA_RTOL, atol=OA_ATOL)
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        return
    trans_b = role == "bp"
    (a,), rows = _dispatched_f32(counts, C, [n if trans_b else k], seed=64)
    b = (np.random.default_rng(65).standard_normal((len(counts), k, n))
         * a.shape[2] ** -0.5).astype(np.float32)
    want = jax.vmap(lambda x, y: jmm(x, y, None, block=(64, 64, 64),
                                     interpret=True, trans_b=trans_b))(
        jnp.asarray(a.numpy()), jnp.asarray(b))
    got = kmm.sr_matmul_batched(a, torch.from_numpy(b), trans_b=trans_b,
                                rows=rows)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_RTOL,
                               atol=MM_ATOL)
    dead = ~kmm.live_rows(rows, C)
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))


def test_f32_batched_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="operands on"):
        kmm.sr_matmul_batched(meta(4, 8, 16), meta(4, 16, 32))
    with pytest.raises(ValueError, match="operands on"):
        koa.outer_accum_batched(meta(4, 8, 16), meta(4, 8, 32))


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("emnk", [(4, 40, 96, 64), (3, 37, 64, 200)], ids=str)
def test_batched_plain_bf16_out_is_the_f32_out_rounded_to_nearest(emnk,
                                                                 trans_b):
    """sr_matmul_batched's plain version with out_dtype bf16 (the FF, BP
    and PREFILL words of an expert table) is its f32 result cast to bf16
    (round to nearest even), bit for bit, with live rows or without;
    rows zero the output past each expert's count."""
    e, m, n, k = emnk
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.standard_normal((e, m, k), np.float32))
    b = torch.from_numpy((rng.standard_normal(
        (e, n, k) if trans_b else (e, k, n)) * k ** -0.5).astype(np.float32))
    a, b = a.bfloat16(), b.bfloat16()
    rows = torch.tensor(rng.integers(0, m + 1, e), dtype=torch.int32)
    for r in (None, rows):
        f32 = kmm.sr_matmul_batched_plain(a, b, trans_b=trans_b, rows=r)
        bf = kmm.sr_matmul_batched(a, b, trans_b=trans_b, rows=r,
                                   out_dtype=torch.bfloat16)
        assert bf.dtype == torch.bfloat16
        assert torch.equal(bf.view(torch.int16),
                           f32.to(torch.bfloat16).view(torch.int16))
    dead = ~kmm.live_rows(rows, m)
    assert torch.equal(f32[dead], torch.zeros_like(f32[dead]))


def test_expert_ablation_edits_find_the_batched_kernel():
    """launch/ablate_experts.py leaves the batched kernel's epilogue or
    mainloop out by editing a copy of csrc/gemm_sm90_batched.cuh: every
    edit's anchor is in the header once, and every variant differs from
    it."""
    from repro_torch.launch import ablate_experts as ablate
    src = (build.CSRC / ablate.HEADER).read_text()
    for name, edits in ablate.VARIANTS.items():
        text = ablate.variant_source(src, edits)
        assert (text == src) == (name == "full"), name
    with pytest.raises(RuntimeError, match="occurs 0 times"):
        ablate.variant_source(src, (("no such line\n", ""),))


def test_f32_expert_ablation_edits_find_the_batched_kernel():
    """launch/ablate_experts.py's f32 variants (zero-fill, mainloop, the
    order of the UP's experts and of FF / BP's tiles) edit copies of
    csrc/sgemm_sm90_batched.cuh: every edit's anchor is in the header
    once, and every variant changes it."""
    from repro_torch.launch import ablate_experts as ablate
    src = (build.CSRC / ablate.HEADER_F32).read_text()
    for name, edits in ablate.VARIANTS_F32.items():
        text = ablate.variant_source(src, edits, ablate.HEADER_F32)
        assert (text == src) == (name == "full"), name
