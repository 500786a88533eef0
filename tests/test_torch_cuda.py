"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (decided in a
fixture, never at import).  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  Tolerances are
those of the CPU parity tests: sr_matmul's and outer_accum's f32 results
rtol 5e-4 / atol 1e-4 (another accumulation order over K or T up to
151936 terms, operands scaled so results are O(1)), fused_attn_unit and
fused_ffn y 2e-2 and caches 6e-2 (bf16 results of f32 sums in another
order); wkv6 y and state 1e-4 (f32 recurrence, fused multiply-adds and
another summation order, values O(1)); wkv6_bwd's outputs within 1e-4
of each one's largest (64-term f32 sums against f64); selective_scan's
y and state within 1e-5 of each one's largest (expf and an f32 sum over
the state against the plain version's f64 ones); every SR result
bit-equal to the plain SR cast of the kernel's own f32 result, and
sr_round bit-exact.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.rounding import sr_cast_bf16  # noqa: E402
from repro_torch.kernels import decode_fused as kdf  # noqa: E402
from repro_torch.kernels import outer_accum as koa  # noqa: E402
from repro_torch.kernels import selective_scan as kss  # noqa: E402
from repro_torch.kernels import sr_matmul as kmm  # noqa: E402
from repro_torch.kernels import sr_round as ksr  # noqa: E402
from repro_torch.kernels import wkv6 as kwkv  # noqa: E402

MM_RTOL, MM_ATOL = 5e-4, 1e-4
Y_TOL, CACHE_TOL = 2e-2, 6e-2
WKV_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("mnk", [(37, 333, 1000), (32, 896, 4864), (1, 8, 8)])
def test_sr_matmul_kernel_matches_plain(dev, mnk, trans_b):
    m, n, k = mnk
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=dev).bfloat16()
    # weights scaled by k^-0.5 as the model's are, so outputs are O(1):
    # the order-of-summation error grows with sum |terms|, which the
    # relative tolerance measures against |result|
    b = (torch.randn((n, k) if trans_b else (k, n), generator=g,
                     device=dev) * k ** -0.5).bfloat16()
    kmm.COUNTER.reset()
    got = kmm.sr_matmul(a, b, trans_b=trans_b)
    assert kmm.COUNTER.n == 1
    want = kmm.sr_matmul_plain(a, b, trans_b=trans_b)
    torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)
    rb = torch.randint(-2**31, 2**31, (m, n), generator=g, device=dev,
                       dtype=torch.int64).to(torch.int32)
    got_sr = kmm.sr_matmul(a, b, rb, trans_b=trans_b)
    assert torch.equal(got_sr.view(torch.int16),
                       sr_cast_bf16(got, rb).view(torch.int16))


CASES = [dict(act="swiglu", norm="rmsnorm", window=None, with_ffn=True),
         dict(act="swiglu", norm="rmsnorm", window=5, with_ffn=True),
         dict(act="swiglu", norm="rmsnorm", window=None, with_ffn=False),
         dict(act="geglu", norm="layernorm", window=None, with_ffn=True),
         dict(act="gelu", norm="rmsnorm", window=None, with_ffn=True),
         dict(act="relu_sq", norm="layernorm", window=None, with_ffn=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_fused_attn_unit_kernel_matches_plain(dev, case):
    B, S, d, H, K, hd, f = 5, 16, 64, 4, 2, 16, 128
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    gated = case["act"] in ("swiglu", "geglu")
    qn = (H + 2 * K) * hd
    w = dict(qkv_w=(rnd(d, qn) * d ** -0.5).bfloat16(),
             o_w=(rnd(H * hd, d) * (H * hd) ** -0.5).bfloat16(),
             qkv_bias=0.3 * rnd(qn), norm1_scale=1 + 0.3 * rnd(d),
             norm2_scale=1 + 0.3 * rnd(d))
    if case["norm"] == "layernorm":
        w.update(norm1_bias=0.2 * rnd(d), norm2_bias=0.2 * rnd(d))
    if case["with_ffn"]:
        w.update(w_in=(rnd(d, 2 * f if gated else f) * d ** -0.5).bfloat16(),
                 w_out=(rnd(f, d) * f ** -0.5).bfloat16())
    fill = torch.tensor([3, 9, 0, 15, 7], device=dev)
    sidx = torch.arange(S, device=dev)[None]
    cache = [rnd(B, S, K, hd).bfloat16(), rnd(B, S, K, hd).bfloat16(),
             torch.where(sidx < fill[:, None], sidx, -1).to(torch.int32)]
    kern = [c.clone() for c in cache]
    plain = [c.cpu() for c in cache]
    active = torch.tensor([True, True, False, True, True], device=dev)
    kw = dict(heads=H, kv_heads=K, head_dim=hd, rope_theta=1e4,
              window=case["window"], norm_kind=case["norm"], act=case["act"],
              with_ffn=case["with_ffn"])
    for t in range(3):
        x = rnd(B, d).bfloat16()
        pos = (fill + t).to(torch.int32)
        y = kdf.fused_attn_unit(x, *kern, pos, active=active, **w, **kw)
        yp = kdf.fused_attn_unit(x.cpu(), *plain, pos.cpu(),
                                 active=active.cpu(),
                                 **{k: v.cpu() for k, v in w.items()}, **kw)
        torch.testing.assert_close(y.cpu().float(), yp.float(), atol=Y_TOL,
                                   rtol=Y_TOL)
    for a, b in zip(kern[:2], plain[:2]):
        torch.testing.assert_close(a.cpu().float(), b.float(),
                                   atol=CACHE_TOL, rtol=CACHE_TOL)
    assert torch.equal(kern[2].cpu(), plain[2])
    for a, b in zip(kern, cache):                 # row 2 inactive
        assert torch.equal(a[2], b[2])


# S = 528 (nine position splits of 64): row 2 attends at position 0 and
# row 0 at 3, so every later split of theirs has no valid position; the
# window of 70 masks whole splits of rows 3 and 4 (the ring wraps at
# row 4's position 528); hd 16 / 64 / 128, up to 16 query heads per KV head
SPLIT_CASES = [dict(hd=64, H=8, K=2, window=None, with_ffn=True),
               dict(hd=128, H=16, K=2, window=None, with_ffn=True),
               dict(hd=128, H=32, K=2, window=70, with_ffn=True),
               dict(hd=64, H=4, K=4, window=70, with_ffn=False),
               dict(hd=16, H=32, K=2, window=None, with_ffn=False)]


def _split_inputs(dev, case, B=5, S=528, d=256, f=512, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    H, K, hd = case["H"], case["K"], case["hd"]
    qn = (H + 2 * K) * hd
    w = dict(qkv_w=(rnd(d, qn) * d ** -0.5).bfloat16(),
             o_w=(rnd(H * hd, d) * (H * hd) ** -0.5).bfloat16(),
             qkv_bias=0.3 * rnd(qn), norm1_scale=1 + 0.3 * rnd(d),
             norm2_scale=1 + 0.3 * rnd(d))
    if case["with_ffn"]:
        w.update(w_in=(rnd(d, 2 * f) * d ** -0.5).bfloat16(),
                 w_out=(rnd(f, d) * f ** -0.5).bfloat16())
    fill = torch.tensor([3, 64, 0, 300, 527] * (B // 5) + [100] * (B % 5),
                        device=dev)
    sidx = torch.arange(S, device=dev)[None]
    cache = [(2 * rnd(B, S, K, hd)).bfloat16(), rnd(B, S, K, hd).bfloat16(),
             torch.where(sidx < fill[:, None], sidx, -1).to(torch.int32)]
    kw = dict(heads=H, kv_heads=K, head_dim=hd, rope_theta=1e4,
              window=case["window"], norm_kind="rmsnorm", act="swiglu",
              with_ffn=case["with_ffn"])
    return w, cache, fill, kw, rnd


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_fused_attn_unit_split_kv_matches_plain(dev, case):
    """The attention split over the cache positions, merged in split
    order, against the plain version's one softmax."""
    w, cache, fill, kw, rnd = _split_inputs(dev, case)
    kern = [c.clone() for c in cache]
    plain = [c.cpu() for c in cache]
    active = torch.tensor([True, True, True, False, True], device=dev)
    kdf.COUNTER.reset()
    kdf.LAUNCHES.reset()
    for t in range(2):
        x = rnd(5, 256).bfloat16()
        pos = (fill + t).to(torch.int32)
        y = kdf.fused_attn_unit(x, *kern, pos, active=active, **w, **kw)
        yp = kdf.fused_attn_unit(x.cpu(), *plain, pos.cpu(),
                                 active=active.cpu(),
                                 **{k: v.cpu() for k, v in w.items()}, **kw)
        torch.testing.assert_close(y.cpu().float(), yp.float(), atol=Y_TOL,
                                   rtol=Y_TOL)
    assert kdf.COUNTER.n == 2
    assert kdf.LAUNCHES.n == 2 * (7 if case["with_ffn"] else 5)
    for a, b in zip(kern[:2], plain[:2]):
        torch.testing.assert_close(a.cpu().float(), b.float(),
                                   atol=CACHE_TOL, rtol=CACHE_TOL)
    assert torch.equal(kern[2].cpu(), plain[2])
    for a, b in zip(kern, cache):                 # row 3 inactive
        assert torch.equal(a[3], b[3])


@pytest.mark.cuda
def test_fused_attn_unit_kernel_two_calls_bit_equal_and_rows_invariant(dev):
    """Split-K and the split-KV merge run in a fixed order: two calls on
    the same inputs give the same bits, and rows 0..4 of a 32-row call
    equal a 5-row call of the same rows."""
    case = SPLIT_CASES[1]
    w, cache, fill, kw, rnd = _split_inputs(dev, case, B=32)
    x = rnd(32, 256).bfloat16()
    pos = (fill + 1).to(torch.int32)
    outs = []
    for rows in (32, 32, 5):
        c = [t[:rows].clone() for t in cache]
        y = kdf.fused_attn_unit(x[:rows].contiguous(), *c,
                                pos[:rows].contiguous(), **w, **kw)
        outs.append([y, *c])
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, b in zip(outs[0], outs[2]):
        assert torch.equal(a[:5], b)


@pytest.mark.cuda
def test_fused_ffn_kernel_two_calls_bit_equal_and_rows_invariant(dev):
    g = torch.Generator(device=dev).manual_seed(9)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    d, f = 2048, 7168
    x = rnd(32, d).bfloat16()
    w = dict(w_in=(rnd(d, f) * d ** -0.5).bfloat16(),
             w_out=(rnd(f, d) * f ** -0.5).bfloat16(),
             norm2_scale=1 + 0.3 * rnd(d), norm2_bias=0.2 * rnd(d))
    kw = dict(norm_kind="layernorm", act="relu_sq", **w)
    y1, y2 = kdf.fused_ffn(x, **kw), kdf.fused_ffn(x, **kw)
    y5 = kdf.fused_ffn(x[:5].contiguous(), **kw)
    assert torch.equal(y1, y2) and torch.equal(y1[:5], y5)


def _rbits(g, shape, dev):
    return torch.randint(-2**31, 2**31, shape, generator=g, device=dev,
                         dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("mnk", [(37, 333, 1000), (256, 896, 4864), (1, 8, 8)])
def test_sr_matmul_f32_operands_match_plain(dev, mnk, trans_b):
    """The fp32 preset's path: f32 A and B on the CUDA cores."""
    m, n, k = mnk
    g = torch.Generator(device=dev).manual_seed(2)
    a = torch.randn((m, k), generator=g, device=dev)
    b = torch.randn((n, k) if trans_b else (k, n), generator=g,
                    device=dev) * k ** -0.5
    kmm.COUNTER.reset()
    got = kmm.sr_matmul(a, b, trans_b=trans_b)
    assert kmm.COUNTER.n == 1 and got.dtype == torch.float32
    want = kmm.sr_matmul_plain(a, b, trans_b=trans_b)
    torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)
    rb = _rbits(g, (m, n), dev)
    assert torch.equal(kmm.sr_matmul(a, b, rb, trans_b=trans_b)
                       .view(torch.int16), sr_cast_bf16(got, rb)
                       .view(torch.int16))


# (m, n, k) of the f32 path off the 128 x 128 x 16 tile: M, N and K not
# multiples of 128 or 16 (or of 4: the scalar loads and stores), N = 1,
# K = 1, and a reduction long enough to split
F32_RAGGED = [(37, 333, 1000), (130, 1, 17), (1, 200, 1), (129, 131, 15),
              (1, 1, 1), (300, 77, 3), (200, 260, 2051), (5, 36, 4100)]


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("mnk", F32_RAGGED, ids=str)
def test_sr_matmul_f32_kernel_ragged_shapes_match_plain(dev, mnk, trans_b):
    """The f32 mainloop zero-fills ragged M, N and K on both operand
    layouts (cp.async for B (K, N), register transposes for A and for
    B (N, K)), and masks its stores; its SR epilogue is the plain SR
    cast of its own f32 result."""
    m, n, k = mnk
    g = torch.Generator(device=dev).manual_seed(11)
    a = torch.randn((m, k), generator=g, device=dev)
    b = torch.randn((n, k) if trans_b else (k, n), generator=g,
                    device=dev) * k ** -0.5
    before = kmm.PATH_COUNTERS["f32"].n
    got = kmm.sr_matmul(a, b, trans_b=trans_b)
    assert kmm.PATH_COUNTERS["f32"].n == before + 1
    torch.testing.assert_close(got, kmm.sr_matmul_plain(a, b, trans_b=trans_b),
                               rtol=MM_RTOL, atol=MM_ATOL)
    rb = _rbits(g, (m, n), dev)
    assert torch.equal(kmm.sr_matmul(a, b, rb, trans_b=trans_b)
                       .view(torch.int16), sr_cast_bf16(got, rb)
                       .view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("tdf", [(1000, 333, 77), (17, 130, 1), (1, 200, 36),
                                 (15, 129, 131), (1, 1, 1), (4100, 36, 5)],
                         ids=str)
def test_outer_accum_f32_kernel_ragged_shapes_match_plain(dev, tdf):
    """dW = X^T dY with both operands copied as they lie (cp.async, 4-byte
    where a row is not 16-byte aligned), ragged T, D and F."""
    t, d, f = tdf
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((t, d), generator=g, device=dev)
    dy = torch.randn((t, f), generator=g, device=dev) * t ** -0.5
    before = koa.PATH_COUNTERS["f32"].n
    got = koa.outer_accum(x, dy, scale=0.5)
    assert koa.PATH_COUNTERS["f32"].n == before + 1
    torch.testing.assert_close(got, koa.outer_accum_plain(x, dy, scale=0.5),
                               rtol=MM_RTOL, atol=MM_ATOL)
    rb = _rbits(g, (d, f), dev)
    assert torch.equal(
        koa.outer_accum(x, dy, scale=0.5, rbits=rb).view(torch.int16),
        sr_cast_bf16(got, rb).view(torch.int16))


# (id, m, k, n, trans_b): the FF and BP products of a full-width qwen2
# training step under fp32 (layers at T = 1024 rows, the tied head per
# 256-row loss chunk; the head's BP cut to 32 rows, its K = vocab kept)
F32_TRAIN = [("ff:qkv", 1024, 896, 1152, False),
             ("ff:o", 1024, 896, 896, False),
             ("ff:ffn_in", 1024, 896, 9728, False),
             ("ff:ffn_out", 1024, 4864, 896, False),
             ("ff:head", 256, 896, 151936, True),
             ("bp:qkv", 1024, 1152, 896, True),
             ("bp:o", 1024, 896, 896, True),
             ("bp:ffn_in", 1024, 9728, 896, True),
             ("bp:ffn_out", 1024, 896, 4864, True),
             ("bp:head", 32, 151936, 896, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_TRAIN, ids=lambda c: c[0])
def test_sr_matmul_f32_training_shapes_match_plain(dev, case):
    _, m, k, n, tb = case
    g = torch.Generator(device=dev).manual_seed(13)
    a = torch.randn((m, k), generator=g, device=dev)
    b = torch.randn((n, k) if tb else (k, n), generator=g,
                    device=dev) * k ** -0.5
    assert kmm.operands_plan(a, b, tb).path == "f32"
    got = kmm.sr_matmul(a, b, trans_b=tb)
    torch.testing.assert_close(got, kmm.sr_matmul_plain(a, b, trans_b=tb),
                               rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in F32_TRAIN
                                  if c[0] in ("ff:o", "bp:ffn_in", "bp:head")],
                         ids=lambda c: c[0])
def test_sr_matmul_f32_split_k_is_deterministic_and_sr_exact(dev, case):
    """f32 split-K sums the partials in split order in the last block of
    each tile (an integer counter, no float atomics): two calls give the
    same bits, and the SR epilogue after it is the plain SR cast of the
    kernel's own f32 result."""
    _, m, k, n, tb = case
    g = torch.Generator(device=dev).manual_seed(14)
    a = torch.randn((m, k), generator=g, device=dev)
    b = torch.randn((n, k) if tb else (k, n), generator=g,
                    device=dev) * k ** -0.5
    assert kmm.operands_plan(a, b, tb).splits > 1
    got = kmm.sr_matmul(a, b, trans_b=tb)
    assert torch.equal(kmm.sr_matmul(a, b, trans_b=tb), got)
    rb = _rbits(g, (m, n), dev)
    assert torch.equal(kmm.sr_matmul(a, b, rb, trans_b=tb).view(torch.int16),
                       sr_cast_bf16(got, rb).view(torch.int16))


@pytest.mark.cuda
def test_outer_accum_f32_split_k_is_deterministic_and_sr_exact(dev):
    """The f32 UP of o (D = F = 896 over T = 1024) splits its token
    reduction: two calls bit-equal, SR bit-equal to the plain cast."""
    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn((1024, 896), generator=g, device=dev)
    dy = torch.randn((1024, 896), generator=g, device=dev) * 1024 ** -0.5
    assert koa.up_plan(x, dy).splits > 1
    got = koa.outer_accum(x, dy, scale=0.25)
    torch.testing.assert_close(got, koa.outer_accum_plain(x, dy, scale=0.25),
                               rtol=MM_RTOL, atol=MM_ATOL)
    assert torch.equal(koa.outer_accum(x, dy, scale=0.25), got)
    rb = _rbits(g, (896, 896), dev)
    assert torch.equal(
        koa.outer_accum(x, dy, scale=0.25, rbits=rb).view(torch.int16),
        sr_cast_bf16(got, rb).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("mnk,trans_b", [
    ((256, 896, 9728), True),      # BP of ffn_in: dY (T, 2f) . W(d, 2f)^T
    ((256, 4864, 896), True),      # BP of ffn_out
    ((256, 896, 151936), False),   # BP of the tied head: g . table
    ((1024, 9728, 896), False),    # FF of ffn_in: x (T, d) . W(d, 2f)
    ((1024, 896, 4864), False),    # FF of ffn_out
    ((256, 151936, 896), True)])   # FF of the tied head: x . table^T
def test_sr_matmul_bp_shapes_match_plain(dev, mnk, trans_b):
    """The training step's BP and FF products (layers at T = 1024, the
    head per loss chunk of 256 rows)."""
    m, n, k = mnk
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn((m, k), generator=g, device=dev).bfloat16()
    b = (torch.randn((n, k) if trans_b else (k, n), generator=g, device=dev)
         * k ** -0.5).bfloat16()
    got = kmm.sr_matmul(a, b, trans_b=trans_b)
    want = kmm.sr_matmul_plain(a, b, trans_b=trans_b)
    torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)


# (T, D, F): the UP shapes of a full-width layer at T = 1024 tokens,
# then ragged T, D and F, then the tied head's UP per loss chunk
UP_SHAPES = [(1024, 896, 1152), (1024, 896, 896), (1024, 896, 9728),
             (1024, 4864, 896), (100, 48, 40), (37, 130, 72),
             (256, 151936, 896)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tdf", UP_SHAPES)
def test_outer_accum_kernel_matches_plain(dev, tdf, dtype):
    t, d, f = tdf
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((t, d), generator=g, device=dev).to(dtype)
    dy = (torch.randn((t, f), generator=g, device=dev) * t ** -0.5).to(dtype)
    koa.COUNTER.reset()
    path = "f32" if dtype == torch.float32 else koa.up_plan(x, dy).path
    before = koa.PATH_COUNTERS[path].n
    got = koa.outer_accum(x, dy, scale=0.5)
    assert koa.COUNTER.n == 1 and got.dtype == torch.float32
    assert koa.PATH_COUNTERS[path].n == before + 1
    want = koa.outer_accum_plain(x, dy, scale=0.5)
    torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)
    rb = _rbits(g, (d, f), dev)
    got_sr = koa.outer_accum(x, dy, scale=0.5, rbits=rb)
    assert got_sr.dtype == torch.bfloat16
    assert torch.equal(got_sr.view(torch.int16),
                       sr_cast_bf16(got, rb).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(4096 * 37, 0), (1001, 0), (4096, 1)])
def test_sr_round_kernel_bit_exact(dev, n, offset):
    """Random f32 bit patterns (NaN payloads, infinities, subnormals) and
    edge values; the vectorised path (n % 4 == 0, aligned) and the scalar
    one (odd n, or a view starting one element in)."""
    g = torch.Generator(device=dev).manual_seed(5)
    raw = torch.randint(-2**31, 2**31, (n + offset,), generator=g,
                        device=dev, dtype=torch.int32)
    edge = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0,
                         -0.0, 1e-40, -1e-40, 3.4028235e38, -3.4028235e38],
                        device=dev)
    raw[offset:offset + edge.numel()] = edge.view(torch.int32)
    x = raw.view(torch.float32)[offset:]
    rb = _rbits(g, (n + offset,), dev)[offset:]
    ksr.COUNTER.reset()
    got = ksr.sr_round(x, rb)
    assert ksr.COUNTER.n == 1
    want = ksr.sr_round_plain(x.cpu(), rb.cpu())
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_sr_round_kernel_at_granite_expert_leaf(dev):
    """The optimizer's writeback of granite's stacked expert table, (24,
    32, 1024, 512): 402,653,184 elements, 1.6 GB of f32, past 2^31 bytes
    of offset.  Elementwise, so the kernel's result is held bit for bit
    against the plain version on slices: the first and last 2^20
    elements and 2^20 around the 2^31-byte mark."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((24, 32, 1024, 512), generator=g, device=dev) * 0.03
    rb = _rbits(g, x.shape, dev)
    got = ksr.sr_round(x, rb).view(-1).view(torch.int16)
    xf, rf, n = x.view(-1), rb.view(-1), x.numel()
    for lo in (0, (1 << 29) - (1 << 19), n - (1 << 20)):
        sl = slice(lo, lo + (1 << 20))
        want = ksr.sr_round_plain(xf[sl], rf[sl]).view(torch.int16)
        assert torch.equal(got[sl], want), lo


# (B, S, H, hd, decay): a 32-token PREFILL chunk of one rwkv6-1.6b slot,
# a DECODE step of 32 slots, a ragged chunk, near-total decay, the
# reduced head sizes, and chunks of several token tiles (a prompt's
# 100-token tail, 257 tokens: nine tiles, the last of one token) and a
# DECODE step on the one-block-a-head plan at hd 32; each with f32 and
# with bf16 r, k, v (the serving path's projections)
WKV_CASES = [(1, 32, 32, 64, None), (32, 1, 32, 64, None),
             (2, 37, 4, 64, None), (1, 32, 32, 64, 1e-6),
             (3, 9, 4, 32, None), (2, 5, 2, 16, None),
             (1, 100, 32, 64, None), (1, 257, 32, 64, None),
             (3, 70, 2, 16, None), (40, 1, 4, 32, None)]
RKV_DTYPES = ["float32", "bfloat16"]


def _wkv_inputs(dev, B, S, H, hd, decay, rkv, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    r, k, v = (0.5 * rnd(B, S, H, hd) for _ in range(3))
    w = (torch.full((B, S, H, hd), decay, device=dev) if decay
         else 0.45 + 0.5 * torch.sigmoid(rnd(B, S, H, hd)))
    u = 0.1 * rnd(H, hd)
    s0 = 0.3 * rnd(B, H, hd, hd)
    dt = getattr(torch, rkv)
    return [t.to(dt) for t in (r, k, v)] + [w, u, s0]


@pytest.mark.cuda
@pytest.mark.parametrize("rkv", RKV_DTYPES)
@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv6_kernel_matches_plain(dev, case, rkv):
    B, S, H, hd, decay = case
    r, k, v, w, u, s0 = _wkv_inputs(dev, B, S, H, hd, decay, rkv, 6)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[B // 2] = B == 1                 # one inactive row when B > 1
    state = s0.clone()
    kwkv.COUNTER.reset()
    shape = {n: c.n for n, c in kwkv.SHAPE_COUNTERS.items()}
    y, s = kwkv.wkv6_bshd(r, k, v, w, u, state, active=active)
    torch.cuda.synchronize()
    assert kwkv.COUNTER.n == 1 and s is state and y.dtype == torch.float32
    kind = "step" if S == 1 else "chunk"      # the launch counted by shape
    assert {n: c.n - shape[n] for n, c in kwkv.SHAPE_COUNTERS.items()} == {
        n: int(n == kind) for n in shape}
    yp, sp = kwkv.wkv6_plain(r, k, v, w, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, yp, atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(s[active], sp[active], atol=WKV_TOL,
                               rtol=WKV_TOL)
    assert torch.equal(s[~active], s0[~active])
    # from zeros, in the TPU kernel's (BH, S, hd) fold
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, hd).contiguous()
    yf, sf = kwkv.wkv6(fold(r), fold(k), fold(v), fold(w),
                       u.repeat(B, 1).contiguous())
    yfp, sfp = kwkv.wkv6_plain(r, k, v, w, u)
    torch.testing.assert_close(yf, fold(yfp), atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(sf, sfp.reshape(B * H, hd, hd),
                               atol=WKV_TOL, rtol=WKV_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rkv", RKV_DTYPES)
@pytest.mark.parametrize("B,S", [(2, 12), (2, 40), (33, 12)])
def test_wkv6_kernel_chunk_equals_single_steps(dev, B, S, rkv):
    """The kernel's per-token arithmetic does not depend on S (nor on the
    plan's tile and column split): a chunk and the same tokens one call
    at a time give the same bits — at B = 33 the single steps run on the
    one-block-a-head plan and the chunk on 16-column blocks."""
    H, hd = 4, 64
    r, k, v, w, u, _ = _wkv_inputs(dev, B, S, H, hd, None, rkv, 7)
    y, s = kwkv.wkv6_bshd(r, k, v, w, u)
    state = torch.zeros_like(s)
    ys = [kwkv.wkv6_bshd(*(t[:, i:i + 1].contiguous() for t in (r, k, v, w)),
                         u, state)[0] for i in range(S)]
    assert torch.equal(torch.cat(ys, dim=1), y) and torch.equal(state, s)
    # bf16 r, k, v give the bits of their f32 casts (exact conversion)
    if rkv == "bfloat16":
        y32, s32 = kwkv.wkv6_bshd(*(t.float() for t in (r, k, v)), w, u)
        assert torch.equal(y32, y) and torch.equal(s32, s)


@pytest.mark.cuda
@pytest.mark.parametrize("rkv", RKV_DTYPES)
@pytest.mark.parametrize("B,S", [(1, 32), (32, 1), (1, 257)])
def test_wkv6_kernel_two_calls_bit_equal(dev, B, S, rkv):
    """Two calls on the same inputs and state give the same bits."""
    H, hd = 32, 64
    r, k, v, w, u, s0 = _wkv_inputs(dev, B, S, H, hd, None, rkv, 8)
    outs = []
    for _ in range(2):
        state = s0.clone()
        y, _ = kwkv.wkv6_bshd(r, k, v, w, u, state)
        outs.append((y, state))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# (B, S, H, hd, decay): the training shape of rwkv6-1.6b (B=4, S=256,
# 32 heads of 64), its head count at hd 16 and 32, one token, 33 tokens
# (a ragged last tile), and near-total decay
WKV_BWD_CASES = [(4, 256, 32, 64, None), (4, 256, 128, 16, None),
                 (4, 256, 64, 32, None), (4, 1, 32, 64, None),
                 (4, 33, 32, 64, None), (2, 33, 4, 16, None),
                 (4, 256, 32, 64, 1e-6)]
# (B, S, H, hd, decay) where the kernel's layout has edges of its own: S
# shorter than a tile, S one past a tile boundary, and B * H = 21 heads
# of 64 (a multiple of neither 132 SMs nor of any block group)
WKV_BWD_EDGE_CASES = [(4, 5, 32, 64, None), (4, 9, 32, 64, None),
                      (3, 40, 7, 64, None)]
# the backward's sums (64-term f32 against the plain version's f64):
# each output within this share of its own largest value
WKV_BWD_REL = 1e-4


def _wkv_bwd_inputs(dev, B, S, H, hd, decay, rkv, seed):
    r, k, v, w, u, _ = _wkv_inputs(dev, B, S, H, hd, decay, rkv, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    return r, k, v, w, u, torch.randn((B, S, H, hd), generator=g,
                                      device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("rkv", RKV_DTYPES)
@pytest.mark.parametrize("case", WKV_BWD_CASES + WKV_BWD_EDGE_CASES, ids=str)
def test_wkv6_bwd_kernel_matches_plain(dev, case, rkv):
    args = _wkv_bwd_inputs(dev, *case, rkv, 9)
    kwkv.BWD_COUNTER.reset()
    got = kwkv.wkv6_bwd(*args)
    torch.cuda.synchronize()
    assert kwkv.BWD_COUNTER.n == 1
    want = kwkv.wkv6_bwd_plain(*args)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        err = float((g - w).abs().max())
        assert err <= WKV_BWD_REL * float(w.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("rkv", RKV_DTYPES)
def test_wkv6_bwd_kernel_two_calls_bit_equal(dev, rkv):
    """No float atomics: the same inputs give the same bits."""
    args = _wkv_bwd_inputs(dev, 4, 256, 32, 64, None, rkv, 10)
    a, b = kwkv.wkv6_bwd(*args), kwkv.wkv6_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("rkv", RKV_DTYPES)
@pytest.mark.parametrize("case", WKV_BWD_EDGE_CASES, ids=str)
def test_wkv6_bwd_kernel_edges_two_calls_bit_equal(dev, case, rkv):
    args = _wkv_bwd_inputs(dev, *case, rkv, 13)
    a, b = kwkv.wkv6_bwd(*args), kwkv.wkv6_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_wkv6_train_runs_both_kernels_and_raises_what_it_does_not_take(dev):
    r, k, v, w, u, dy = _wkv_bwd_inputs(dev, 2, 40, 4, 64, None, "bfloat16",
                                        11)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    kwkv.COUNTER.reset()
    kwkv.BWD_COUNTER.reset()
    y = kwkv.wkv6_train(*leaves)
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    assert (kwkv.COUNTER.n, kwkv.BWD_COUNTER.n) == (1, 1)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 \
        + [torch.float32] * 2
    # the forward's and the backward's kernels, their results as they are
    # (dr, dk, dv rounded to r's dtype)
    assert torch.equal(y, kwkv.wkv6_bshd(r, k, v, w, u)[0])
    for g, want in zip(grads, kwkv.wkv6_bwd(r, k, v, w, u, dy)):
        assert torch.equal(g, want.to(g.dtype))
    # head_dim 128: no instantiation
    big = _wkv_bwd_inputs(dev, 1, 4, 2, 128, None, "float32", 12)
    with pytest.raises(ValueError, match="head_dim"):
        kwkv.wkv6_bwd(*big)
    # a carried state: training runs from zeros and has no gradient for it
    state = torch.zeros((2, 4, 64, 64), device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="carried state"):
        kwkv.wkv6_train(*leaves, state)


@pytest.mark.cuda
@pytest.mark.parametrize("B,d,f,norm,act", [
    (32, 2048, 7168, "layernorm", "relu_sq"),
    (5, 64, 128, "rmsnorm", "swiglu"), (3, 200, 72, "layernorm", "gelu")])
def test_fused_ffn_kernel_matches_plain(dev, B, d, f, norm, act):
    g = torch.Generator(device=dev).manual_seed(8)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    gated = act == "swiglu"
    x = rnd(B, d).bfloat16()
    w = dict(w_in=(rnd(d, 2 * f if gated else f) * d ** -0.5).bfloat16(),
             w_out=(rnd(f, d) * f ** -0.5).bfloat16(),
             norm2_scale=1 + 0.3 * rnd(d),
             norm2_bias=0.2 * rnd(d) if norm == "layernorm" else None)
    kdf.FFN_COUNTER.reset()
    y = kdf.fused_ffn(x, norm_kind=norm, act=act, **w)
    torch.cuda.synchronize()
    assert kdf.FFN_COUNTER.n == 1 and y.dtype == torch.bfloat16
    yp = kdf.fused_ffn(x.cpu(), norm_kind=norm, act=act,
                       **{k: None if v is None else v.cpu()
                          for k, v in w.items()})
    torch.testing.assert_close(y.cpu().float(), yp.float(), atol=Y_TOL,
                               rtol=Y_TOL)


# ---------------------------------------------------------------------------
# The sm90 mainloop (TMA + wgmma, deterministic split-K) at the main path's
# shapes, and the generic path on what the TMA cannot describe
# ---------------------------------------------------------------------------

# (id, M, K, N, trans_b, row stride of B or None): chip_smoke.py's PREFILL
# shapes (32-token chunk) of qwen2-0.5b and rwkv6-1.6b (whose r, k, v, g
# quarters are column views of the (2048, 8192) table), and the FF and
# BP shapes of a qwen2 training step (T = 1024, the head per 256 rows)
SM90_SHAPES = [
    ("qwen2:prefill:qkv", 32, 896, 1152, False, None),
    ("qwen2:prefill:o", 32, 896, 896, False, None),
    ("qwen2:prefill:ffn_in", 32, 896, 9728, False, None),
    ("qwen2:prefill:ffn_out", 32, 4864, 896, False, None),
    ("qwen2:prefill:head", 32, 896, 151936, True, None),
    ("rwkv6:prefill:rkvg", 32, 2048, 2048, False, 8192),
    ("rwkv6:prefill:decay", 32, 2048, 2048, False, None),
    ("rwkv6:prefill:ffn_in", 32, 2048, 7168, False, None),
    ("rwkv6:prefill:ffn_out", 32, 7168, 2048, False, None),
    ("rwkv6:prefill:head", 32, 2048, 65536, False, None),
    ("qwen2:ff:qkv", 1024, 896, 1152, False, None),
    ("qwen2:ff:o", 1024, 896, 896, False, None),
    ("qwen2:ff:ffn_out", 1024, 4864, 896, False, None),
    ("qwen2:ff:head", 256, 896, 151936, True, None),
    ("qwen2:bp:qkv", 1024, 1152, 896, True, None),
    ("qwen2:bp:o", 1024, 896, 896, True, None),
    ("qwen2:bp:ffn_in", 1024, 9728, 896, True, None),
    ("qwen2:bp:head", 256, 151936, 896, False, None),
    ("jamba:prefill:qkv", 32, 4096, 6144, False, None),
    ("jamba:prefill:o", 32, 4096, 4096, False, None),
    ("jamba:prefill:ffn_in", 32, 4096, 28672, False, None),
    ("jamba:prefill:ffn_out", 32, 14336, 4096, False, None),
    ("jamba:prefill:mamba_in", 32, 4096, 16384, False, None),
    ("jamba:prefill:mamba_xproj", 32, 8192, 288, False, None),
    ("jamba:prefill:mamba_dt", 32, 256, 8192, False, None),
    ("jamba:prefill:mamba_out", 32, 8192, 4096, False, None),
    ("jamba:prefill:head", 32, 4096, 65536, False, None)]
# A's row stride where the main path passes A as a view of wider rows:
# jamba's dt projection reads the first dt_rank (256) columns of the
# (dt, B, C) projection, rows of 256 + 2 x 16
A_STRIDE = {"jamba:prefill:mamba_dt": 288}


def _operands(g, dev, m, k, n, trans_b, ldb=None, lda=None):
    """A (m, k) and B ((n, k) with trans_b, else (k, n)) in bf16, B scaled
    by k^-0.5; with ldb, B is the first columns of a wider matrix, with
    lda A."""
    a = torch.randn((m, lda or k), generator=g, device=dev).bfloat16()[:, :k]
    rows, cols = (n, k) if trans_b else (k, n)
    full = (torch.randn((rows, ldb or cols), generator=g, device=dev)
            * k ** -0.5).bfloat16()
    return a, full[:, :cols]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SM90_SHAPES, ids=lambda c: c[0])
def test_sr_matmul_sm90_main_shapes_match_plain(dev, case):
    name, m, k, n, tb, ldb = case
    g = torch.Generator(device=dev).manual_seed(5)
    a, b = _operands(g, dev, m, k, n, tb, ldb, A_STRIDE.get(name))
    assert kmm.operands_plan(a, b, tb).path == "sm90"
    before = {p: c.n for p, c in kmm.PATH_COUNTERS.items()}
    got = kmm.sr_matmul(a, b, trans_b=tb)
    assert kmm.PATH_COUNTERS["sm90"].n == before["sm90"] + 1
    assert kmm.PATH_COUNTERS["generic"].n == before["generic"]
    want = kmm.sr_matmul_plain(a, b, trans_b=tb)
    torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in SM90_SHAPES
                                  if c[0] in ("qwen2:bp:head",
                                              "qwen2:prefill:ffn_out",
                                              "rwkv6:prefill:ffn_out")],
                         ids=lambda c: c[0])
def test_sr_matmul_split_k_is_deterministic_and_sr_exact(dev, case):
    """Split-K with no float atomics: two calls give the same bits, and
    the SR epilogue after the split reduction is bit-equal to the plain
    SR cast of the kernel's own f32 result."""
    _, m, k, n, tb, ldb = case
    g = torch.Generator(device=dev).manual_seed(6)
    a, b = _operands(g, dev, m, k, n, tb, ldb)
    assert kmm.operands_plan(a, b, tb).splits > 1
    got = kmm.sr_matmul(a, b, trans_b=tb)
    assert torch.equal(kmm.sr_matmul(a, b, trans_b=tb), got)
    rb = _rbits(g, (m, n), dev)
    assert torch.equal(kmm.sr_matmul(a, b, rb, trans_b=tb).view(torch.int16),
                       sr_cast_bf16(got, rb).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in SM90_SHAPES
                                  if ":prefill:" in c[0]],
                         ids=lambda c: c[0])
def test_sr_matmul_rows_do_not_depend_on_m(dev, case):
    """Rows 0..4 of a 32-row PREFILL chunk equal a 5-row call of the same
    rows, bit for bit (the plan's splits depend on N, K and layout only)."""
    name, m, k, n, tb, ldb = case
    g = torch.Generator(device=dev).manual_seed(7)
    a, b = _operands(g, dev, m, k, n, tb, ldb, A_STRIDE.get(name))
    assert torch.equal(kmm.sr_matmul(a[:5].clone(), b, trans_b=tb),
                       kmm.sr_matmul(a, b, trans_b=tb)[:5])


@pytest.mark.cuda
def test_outer_accum_split_k_sr_exact_and_deterministic(dev):
    """A narrow dW over many tokens plans splits > 1 (no main-path UP
    does): deterministic, and SR bit-equal to the plain cast."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((8192, 128), generator=g, device=dev).bfloat16()
    dy = (torch.randn((8192, 96), generator=g, device=dev)
          * 8192 ** -0.5).bfloat16()
    assert koa.up_plan(x, dy).splits > 1
    got = koa.outer_accum(x, dy, scale=0.25)
    torch.testing.assert_close(got, koa.outer_accum_plain(x, dy, scale=0.25),
                               rtol=MM_RTOL, atol=MM_ATOL)
    assert torch.equal(koa.outer_accum(x, dy, scale=0.25), got)
    rb = _rbits(g, (128, 96), dev)
    assert torch.equal(
        koa.outer_accum(x, dy, scale=0.25, rbits=rb).view(torch.int16),
        sr_cast_bf16(got, rb).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("quarter", range(4))
def test_sr_matmul_reads_rkvg_views_in_place(dev, quarter):
    """rwkv6's r, k, v, g quarters: a column view of the (2048, 8192)
    table runs the sm90 path as it lies and equals its contiguous copy."""
    g = torch.Generator(device=dev).manual_seed(9)
    a = torch.randn((32, 2048), generator=g, device=dev).bfloat16()
    table = (torch.randn((2048, 8192), generator=g, device=dev)
             * 2048 ** -0.5).bfloat16()
    view = table[:, quarter * 2048:(quarter + 1) * 2048]
    assert kmm.operand(view) is view
    assert kmm.operands_plan(a, view).path == "sm90"
    assert torch.equal(kmm.sr_matmul(a, view),
                       kmm.sr_matmul(a, view.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 32])
def test_sr_matmul_reads_a_strided_dt_view_in_place(dev, m):
    """jamba's mamba_dt: A is the first 256 columns of (m, 288) rows (a
    PREFILL chunk of m tokens), read as it lies on the sm90 path, equal to
    the plain version and to its contiguous copy's product bit for bit."""
    g = torch.Generator(device=dev).manual_seed(11)
    proj = torch.randn((m, 288), generator=g, device=dev).bfloat16()
    view = proj[:, :256]
    w = (torch.randn((256, 8192), generator=g, device=dev)
         * 256 ** -0.5).bfloat16()
    assert kmm.operand(view) is view
    assert kmm.operands_plan(view, w).path == "sm90"
    before = {p: c.n for p, c in kmm.PATH_COUNTERS.items()}
    got = kmm.sr_matmul(view, w)
    assert kmm.PATH_COUNTERS["sm90"].n == before["sm90"] + 1
    assert kmm.PATH_COUNTERS["generic"].n == before["generic"]
    torch.testing.assert_close(got, kmm.sr_matmul_plain(view, w),
                               rtol=MM_RTOL, atol=MM_ATOL)
    assert torch.equal(got, kmm.sr_matmul(view.contiguous(), w))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 32])
@pytest.mark.parametrize("kn", [(4096, 14336), (14336, 4096)], ids=str)
def test_sr_matmul_batched_at_jamba_prefill_shapes(dev, kn, c):
    """jamba's expert tables (16 experts, 4096 -> 14336 -> 4096) in a
    PREFILL chunk, C = 8 and 32 rows an expert, each expert's live rows
    from a routing of C tokens' top-2: one launch on the sm90 path; f32
    out within the f32 path's tolerance of the plain version, bf16 out
    the f32 out rounded to nearest even, two calls bit-equal."""
    from repro_torch.models import moe
    k, n = kn
    g = torch.Generator(device=dev).manual_seed(57)
    experts = torch.stack([torch.randperm(16, generator=g, device=dev)[:2]
                           for _ in range(c)]).reshape(-1)
    rows = moe._expert_rows(experts.reshape(c, 2), 16, c)
    live = torch.arange(c, device=dev)[None, :, None] < rows[:, None, None]
    a = torch.where(live, torch.randn((16, c, k), generator=g, device=dev),
                    0.0).bfloat16()
    w = (torch.randn((16, k, n), generator=g, device=dev)
         * k ** -0.5).bfloat16()
    before = {p: cnt.n for p, cnt in kmm.PATH_COUNTERS.items()}
    b0 = kmm.BATCHED_COUNTER.n
    got = kmm.sr_matmul_batched(a, w, rows=rows)
    assert kmm.BATCHED_COUNTER.n == b0 + 1
    assert kmm.PATH_COUNTERS["sm90"].n == before["sm90"] + 1
    assert kmm.PATH_COUNTERS["generic"].n == before["generic"]
    torch.testing.assert_close(got, kmm.sr_matmul_batched_plain(
        a, w, rows=rows), rtol=MM_RTOL, atol=MM_ATOL)
    got16 = kmm.sr_matmul_batched(a, w, rows=rows, out_dtype=torch.bfloat16)
    assert torch.equal(got16.view(torch.int16),
                       got.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(kmm.sr_matmul_batched(a, w, rows=rows), got)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["row-666B", "base-unaligned"])
def test_generic_path_takes_what_tma_cannot_describe(dev, what):
    g = torch.Generator(device=dev).manual_seed(10)
    if what == "row-666B":
        a = torch.randn((37, 1000), generator=g, device=dev).bfloat16()
        b = torch.randn((1000, 333), generator=g, device=dev).bfloat16()
    else:   # rows 1808 bytes apart, but the view starts 2 bytes in
        a = torch.randn((32, 904), generator=g,
                        device=dev).bfloat16()[:, 1:897]
        b = (torch.randn((896, 896), generator=g, device=dev)
             * 896 ** -0.5).bfloat16()
    assert kmm.operands_plan(a, b).path == "generic"
    before = {p: c.n for p, c in kmm.PATH_COUNTERS.items()}
    got = kmm.sr_matmul(a, b)
    assert kmm.PATH_COUNTERS["generic"].n == before["generic"] + 1
    assert kmm.PATH_COUNTERS["sm90"].n == before["sm90"]
    torch.testing.assert_close(got, kmm.sr_matmul_plain(a, b), rtol=MM_RTOL,
                               atol=MM_ATOL)


# ---------------------------------------------------------------------------
# The paper networks' product shapes (runtime/paper_step.py)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("tdf", [(401408, 3, 64), (387200, 3, 96)],
                         ids=["vgg16-conv1-B8", "alexnet-conv1-B128"])
def test_outer_accum_f32_conv_tap_with_three_channels(dev, tdf):
    """A conv tap of the first conv (Ci = 3): 12-byte rows of X, which
    take the f32 path's 4-byte cp.async loads, over T ~ 400,000 rows into
    one (3, Co) tile — split over the reduction, summed in split order:
    two calls bit-equal."""
    t, d, f = tdf
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((t, d), generator=g, device=dev)
    dy = torch.randn((t, f), generator=g, device=dev) * t ** -0.5
    p = koa.up_plan(x, dy)
    assert p.path == "f32" and p.splits > 1
    before = koa.PATH_COUNTERS["f32"].n
    got = koa.outer_accum(x, dy)
    assert koa.PATH_COUNTERS["f32"].n == before + 1
    torch.testing.assert_close(got, koa.outer_accum_plain(x, dy),
                               rtol=MM_RTOL, atol=MM_ATOL)
    assert torch.equal(koa.outer_accum(x, dy), got)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True], ids=["ff", "bp"])
def test_sr_matmul_f32_skinny_captioning_product(dev, trans_b):
    """The captioning GRU's input product at B = 8: x (8, 43264) . wx
    (43264, 30000) as FF, and dG (8, 30000) . wx^T as BP (trans_b, wx
    read as stored): one 128-row tile of which 8 rows are real."""
    m, k, n = (8, 43264, 30000) if not trans_b else (8, 30000, 43264)
    g = torch.Generator(device=dev).manual_seed(22)
    a = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((43264, 30000), generator=g, device=dev) * k ** -0.5
    assert kmm.operands_plan(a, w, trans_b).path == "f32"
    before = kmm.PATH_COUNTERS["f32"].n
    got = kmm.sr_matmul(a, w, trans_b=trans_b)
    assert kmm.PATH_COUNTERS["f32"].n == before + 1
    torch.testing.assert_close(got, kmm.sr_matmul_plain(a, w,
                                                        trans_b=trans_b),
                               rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["ff", "bp", "up"])
@pytest.mark.parametrize("k", [4096, 9216])
def test_fc_products_with_1000_classes(dev, role, k):
    """The last FC layer of AlexNet / VGG-16 (4096 -> 1000) at B = 128,
    and the first's K = 9216, in bf16 on the sm90 path: FF x . W, BP
    dY . W^T (K = 1000), UP X^T dY (F = 1000)."""
    g = torch.Generator(device=dev).manual_seed(23)
    before = {p: c.n for p, c in kmm.PATH_COUNTERS.items()}
    up_before = {p: c.n for p, c in koa.PATH_COUNTERS.items()}
    if role == "up":
        x = torch.randn((128, k), generator=g, device=dev).bfloat16()
        dy = (torch.randn((128, 1000), generator=g, device=dev)
              * 128 ** -0.5).bfloat16()
        assert koa.up_plan(x, dy).path == "sm90"
        got, want = koa.outer_accum(x, dy), koa.outer_accum_plain(x, dy)
        assert koa.PATH_COUNTERS["sm90"].n == up_before["sm90"] + 1
    else:
        w = (torch.randn((k, 1000), generator=g, device=dev)
             * k ** -0.5).bfloat16()
        a = torch.randn((128, k if role == "ff" else 1000), generator=g,
                        device=dev).bfloat16()
        tb = role == "bp"
        assert kmm.operands_plan(a, w, tb).path == "sm90"
        got = kmm.sr_matmul(a, w, trans_b=tb)
        want = kmm.sr_matmul_plain(a, w, trans_b=tb)
        assert kmm.PATH_COUNTERS["sm90"].n == before["sm90"] + 1
    torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(11, 4, "VALID", 99, 3, 96, 4),
                                  (5, 1, "SAME", 27, 96, 256, 2),
                                  (3, 1, "SAME", 56, 3, 64, 4)],
                         ids=["alexnet-conv1", "alexnet-conv2", "vgg-conv1"])
def test_conv_up_as_matmul_matches_autograd_conv_dw(dev, case):
    """The Fig 6 lowering on the card — one f32 outer_accum launch a tap
    — against autograd's conv dW in f64: an f32 sum in another order,
    within 1e-4 of the largest |dW|."""
    from repro_torch.models import cnn
    k, s, pad, hw, ci, co, B = case
    g = torch.Generator(device=dev).manual_seed(24)
    ho = (hw - k) // s + 1 if pad == "VALID" else hw
    x = torch.randn((B, hw, hw, ci), generator=g, device=dev)
    dy = torch.randn((B, ho, ho, co), generator=g, device=dev)
    before = (koa.COUNTER.n, koa.PATH_COUNTERS["f32"].n)
    got = cnn.conv_up_as_matmul(x, dy, k, s, pad, backend="cuda")
    assert koa.COUNTER.n - before[0] == k * k
    assert koa.PATH_COUNTERS["f32"].n - before[1] == k * k
    w = torch.zeros((co, ci, k, k), dtype=torch.float64, device=dev,
                    requires_grad=True)
    y = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2), w,
                                   stride=s,
                                   padding=k // 2 if pad == "SAME" else 0)
    dw, = torch.autograd.grad(y, w, dy.double().permute(0, 3, 1, 2))
    want = dw.permute(2, 3, 1, 0)
    err = float((got.double() - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max())


# ---------------------------------------------------------------------------
# sr_matmul's batched mode: a MoE table's PREFILL product, one launch
# ---------------------------------------------------------------------------


def _batched_operands(dev, e, m, n, k, trans_b, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((e, m, k), generator=g, device=dev).bfloat16()
    b = (torch.randn((e, n, k) if trans_b else (e, k, n), generator=g,
                     device=dev) * k ** -0.5).bfloat16()
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("kn", [(1024, 512), (512, 1024), (64, 96)], ids=str)
@pytest.mark.parametrize("m", [1, 8, 32, 40, 130])
@pytest.mark.parametrize("e", [1, 4, 32])
def test_sr_matmul_batched_kernel_matches_plain(dev, e, m, kn, trans_b):
    """One launch a call, on the sm90 path, counted on sr_matmul,
    sr_matmul:sm90 and sr_matmul:batched; each expert within the f32
    path's tolerance of the plain version."""
    k, n = kn
    a, b = _batched_operands(dev, e, m, n, k, trans_b, seed=30)
    before = {name: c.n for name, c in (("all", kmm.COUNTER),
                                        ("batched", kmm.BATCHED_COUNTER),
                                        *kmm.PATH_COUNTERS.items())}
    got = kmm.sr_matmul_batched(a, b, trans_b=trans_b)
    after = {name: c.n for name, c in (("all", kmm.COUNTER),
                                       ("batched", kmm.BATCHED_COUNTER),
                                       *kmm.PATH_COUNTERS.items())}
    assert {k_: after[k_] - before[k_] for k_ in after} == {
        "all": 1, "batched": 1, "sm90": 1, "generic": 0, "f32": 0}
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, m, n)
    want = kmm.sr_matmul_batched_plain(a, b, trans_b=trans_b)
    torch.testing.assert_close(got, want, rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("emnk", [(32, 40, 512, 1024), (4, 130, 96, 64),
                                  (2, 8, 64, 4096)], ids=str)
def test_sr_matmul_batched_kernel_two_calls_bit_equal(dev, emnk, trans_b):
    """Two calls give the same bits; (2, 8, 64, 4096) takes a split-K plan
    (partials summed in split order), which must match the plain version
    too."""
    e, m, n, k = emnk
    a, b = _batched_operands(dev, e, m, n, k, trans_b, seed=31)
    p = kmm.plan(m, n, k, "k", "k" if trans_b else "n", experts=e)
    assert p.path == "sm90" and (p.splits > 1) == (k == 4096)
    first = kmm.sr_matmul_batched(a, b, trans_b=trans_b)
    assert torch.equal(first, kmm.sr_matmul_batched(a, b, trans_b=trans_b))
    torch.testing.assert_close(first, kmm.sr_matmul_batched_plain(
        a, b, trans_b=trans_b), rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
def test_sr_matmul_batched_kernel_reads_no_other_expert(dev, trans_b):
    """Expert 1's operands are all inf: a tile of expert 0 or 2 that read
    across a boundary (a K tile past K = 72, rows past M = 40 or N = 72)
    would turn its outputs inf or NaN.  Experts 0 and 2 stay finite and
    match the plain version."""
    e, m, n, k = 3, 40, 72, 72
    a, b = _batched_operands(dev, e, m, n, k, trans_b, seed=32)
    a[1] = float("inf")
    b[1] = float("inf")
    got = kmm.sr_matmul_batched(a, b, trans_b=trans_b)
    want = kmm.sr_matmul_batched_plain(a, b, trans_b=trans_b)
    for i in (0, 2):
        assert torch.isfinite(got[i]).all()
        torch.testing.assert_close(got[i], want[i], rtol=MM_RTOL,
                                   atol=MM_ATOL)


@pytest.mark.cuda
def test_sr_matmul_batched_raises_on_what_the_tma_cannot_describe(dev):
    a, b = _batched_operands(dev, 4, 8, 64, 64, False, seed=33)
    flat = torch.empty(a.numel() + 1, dtype=torch.bfloat16, device=dev)
    off = flat[1:].view(a.shape)                       # 2 bytes off 16
    off.copy_(a)
    assert off.is_contiguous() and off.data_ptr() % 16
    n0 = kmm.COUNTER.n
    with pytest.raises(ValueError, match="16-byte"):
        kmm.sr_matmul_batched(off, b)
    a12, b12 = _batched_operands(dev, 4, 8, 64, 12, False, seed=34)
    with pytest.raises(ValueError, match="16-byte"):
        kmm.sr_matmul_batched(a12, b12)                # K = 12: 24-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        kmm.sr_matmul_batched(a.transpose(1, 2).contiguous().transpose(1, 2),
                              b)
    with pytest.raises(TypeError, match="two bf16 or two f32"):
        kmm.sr_matmul_batched(a.float(), b)
    assert kmm.COUNTER.n == n0


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 32])
def test_sr_matmul_trans_b_at_granite_odd_vocab(dev, m):
    """granite's tied head: B (49155, 1024) read through trans_b, an f32
    output with an odd row length (the epilogue's scalar stores, the TMA
    box past the last of 49155 rows); and its SR form."""
    g = torch.Generator(device=dev).manual_seed(35)
    a = torch.randn((m, 1024), generator=g, device=dev).bfloat16()
    w = (torch.randn((49155, 1024), generator=g, device=dev)
         * 1024 ** -0.5).bfloat16()
    assert kmm.operands_plan(a, w, True).path == "sm90"
    got = kmm.sr_matmul(a, w, trans_b=True)
    torch.testing.assert_close(got, kmm.sr_matmul_plain(a, w, trans_b=True),
                               rtol=MM_RTOL, atol=MM_ATOL)
    rb = torch.randint(-2**31, 2**31, (m, 49155), generator=g, device=dev,
                       dtype=torch.int64).to(torch.int32)
    got_sr = kmm.sr_matmul(a, w, rb, trans_b=True)
    assert torch.equal(got_sr.view(torch.int16),
                       sr_cast_bf16(got, rb).view(torch.int16))


@pytest.mark.cuda
def test_fused_attn_unit_without_ffn_at_granite_widths(dev):
    """A MoE unit's fused attention half at granite's widths (d 1024, 16
    heads of 64, 8 KV heads, B = 32, S = 528): five launches a call,
    within the fused word's tolerances of the plain version."""
    B, S, d, H, K, hd = 32, 528, 1024, 16, 8, 64
    g = torch.Generator(device=dev).manual_seed(36)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    qn = (H + 2 * K) * hd
    w = dict(qkv_w=(rnd(d, qn) * d ** -0.5).bfloat16(),
             o_w=(rnd(H * hd, d) * (H * hd) ** -0.5).bfloat16(),
             qkv_bias=None, norm1_scale=1 + 0.3 * rnd(d))
    fill = torch.randint(0, S - 3, (B,), generator=g, device=dev)
    sidx = torch.arange(S, device=dev)[None]
    cache = [rnd(B, S, K, hd).bfloat16(), rnd(B, S, K, hd).bfloat16(),
             torch.where(sidx < fill[:, None], sidx, -1).to(torch.int32)]
    kern = [c.clone() for c in cache]
    plain = [c.cpu() for c in cache]
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[7] = False
    kw = dict(heads=H, kv_heads=K, head_dim=hd, rope_theta=1e4,
              norm_kind="rmsnorm", act="swiglu", with_ffn=False)
    assert kdf.decode_plan(B, d, heads=H, kv_heads=K, head_dim=hd, S=S,
                           with_ffn=False).launches == 5
    for t in range(2):
        x = rnd(B, d).bfloat16()
        pos = (fill + t).to(torch.int32)
        l0 = kdf.LAUNCHES.n
        y = kdf.fused_attn_unit(x, *kern, pos, active=active, **w, **kw)
        assert kdf.LAUNCHES.n - l0 == 5
        yp = kdf.fused_attn_unit(x.cpu(), *plain, pos.cpu(),
                                 active=active.cpu(),
                                 **{k: v if v is None else v.cpu()
                                    for k, v in w.items()}, **kw)
        torch.testing.assert_close(y.cpu().float(), yp.float(), atol=Y_TOL,
                                   rtol=Y_TOL)
    for a, b in zip(kern[:2], plain[:2]):
        torch.testing.assert_close(a.cpu().float(), b.float(),
                                   atol=CACHE_TOL, rtol=CACHE_TOL)
    assert torch.equal(kern[2].cpu(), plain[2])
    for a, b in zip(kern, cache):
        assert torch.equal(a[7], b[7])


# ---------------------------------------------------------------------------
# A MoE table's training words: outer_accum's batched mode (UP), and
# sr_matmul's batched mode at the FF / BP shapes, behind dispatch._PEMatmul
# ---------------------------------------------------------------------------


def _up_operands(dev, e, t, d, f, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((e, t, d), generator=g, device=dev).bfloat16()
    dy = (torch.randn((e, t, f), generator=g, device=dev)
          * max(t, 1) ** -0.5).bfloat16()
    return x, dy, g


def _up_bits(g, dev, shape, mode):
    from repro_torch.core.rounding import make_rbits
    return make_rbits(shape, g, device=dev, lo=mode == "sr_lo")


def _oa_counts():
    return {name: c.n for name, c in (("all", koa.COUNTER),
                                      ("batched", koa.BATCHED_COUNTER),
                                      *koa.PATH_COUNTERS.items())}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "sr", "sr_lo"])
@pytest.mark.parametrize("df", [(1024, 512), (512, 1024)], ids=str)
@pytest.mark.parametrize("t", [1, 8, 40, 1024])
@pytest.mark.parametrize("e", [1, 4, 32])
def test_outer_accum_batched_kernel_matches_plain(dev, e, t, df, mode):
    """One launch a call on the sm90 path, counted on outer_accum,
    outer_accum:sm90 and outer_accum:batched; the f32 result within the
    f32 path's tolerance of the plain version, the SR result (full or
    LO bits, each expert's its own) bit-equal to the plain SR cast of
    the kernel's own f32 result."""
    d, f = df
    x, dy, g = _up_operands(dev, e, t, d, f, seed=50)
    before = _oa_counts()
    got = koa.outer_accum_batched(x, dy)
    moved = {k: v - before[k] for k, v in _oa_counts().items()}
    assert moved == {"all": 1, "batched": 1, "sm90": 1, "generic": 0,
                     "f32": 0}
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, d, f)
    if mode == "f32":
        torch.testing.assert_close(got, koa.outer_accum_batched_plain(x, dy),
                                   rtol=MM_RTOL, atol=MM_ATOL)
        return
    rb = _up_bits(g, dev, (e, d, f), mode)
    got_sr = koa.outer_accum_batched(x, dy, rbits=rb)
    assert got_sr.dtype == torch.bfloat16
    assert torch.equal(got_sr.view(torch.int16),
                       sr_cast_bf16(got, rb).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("etdf", [(32, 1024, 1024, 512), (32, 1024, 512, 1024),
                                  (2, 4096, 64, 64)], ids=str)
def test_outer_accum_batched_kernel_two_calls_bit_equal(dev, etdf, sr):
    """Two calls give the same bits; (2, 4096, 64, 64) takes a split
    plan (partials summed in split order, then the scale and SR once),
    which must match the plain version too."""
    e, t, d, f = etdf
    x, dy, g = _up_operands(dev, e, t, d, f, seed=51)
    p = koa.batched_plan(e, t, d, f)
    assert p.path == "sm90" and (p.splits > 1) == (t == 4096)
    rb = _up_bits(g, dev, (e, d, f), "sr") if sr else None
    first = koa.outer_accum_batched(x, dy, rbits=rb)
    again = koa.outer_accum_batched(x, dy, rbits=rb)
    assert torch.equal(first.view(torch.int16 if sr else torch.int32),
                       again.view(torch.int16 if sr else torch.int32))
    f32 = koa.outer_accum_batched(x, dy)
    torch.testing.assert_close(f32, koa.outer_accum_batched_plain(x, dy),
                               rtol=MM_RTOL, atol=MM_ATOL)
    if sr:
        assert torch.equal(first.view(torch.int16),
                           sr_cast_bf16(f32, rb).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [40, 100])
def test_outer_accum_batched_kernel_reads_no_other_expert(dev, t):
    """Expert 1's X and dY are all inf: a token box of expert 0 past its
    T (40 or 100 tokens: a 64-token box crosses) that read expert 1's
    rows would turn its dW inf or NaN.  Experts 0 and 2 stay finite and
    match the plain version."""
    e, d, f = 3, 72, 72
    x, dy, _ = _up_operands(dev, e, t, d, f, seed=52)
    x[1] = float("inf")
    dy[1] = float("inf")
    got = koa.outer_accum_batched(x, dy)
    want = koa.outer_accum_batched_plain(x, dy)
    for i in (0, 2):
        assert torch.isfinite(got[i]).all()
        torch.testing.assert_close(got[i], want[i], rtol=MM_RTOL,
                                   atol=MM_ATOL)


@pytest.mark.cuda
def test_outer_accum_batched_kernel_puts_each_experts_bits_on_its_dw(dev):
    """Each expert gets its own bits: all-zero low halves (SR truncates)
    on even experts, all-ones (SR rounds every inexact value up) on odd
    ones.  Each expert's dW equals the plain SR cast of the kernel's own
    f32 result with its bits, and not with its neighbour's."""
    e, t, d, f = 4, 1024, 512, 1024
    x, dy, _ = _up_operands(dev, e, t, d, f, seed=53)
    rb = torch.zeros((e, d, f), dtype=torch.int32, device=dev)
    rb[1::2] = 0xFFFF
    got = koa.outer_accum_batched(x, dy, rbits=rb)
    f32 = koa.outer_accum_batched(x, dy)
    for i in range(e):
        own = sr_cast_bf16(f32[i], rb[i]).view(torch.int16)
        other = sr_cast_bf16(f32[i], rb[i ^ 1]).view(torch.int16)
        assert torch.equal(got[i].view(torch.int16), own)
        assert not torch.equal(got[i].view(torch.int16), other)


@pytest.mark.cuda
def test_outer_accum_batched_raises_on_what_the_tma_cannot_describe(dev):
    x, dy, g = _up_operands(dev, 4, 40, 64, 32, seed=54)
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=dev)
    off = flat[1:].view(x.shape)                       # 2 bytes off 16
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16
    n0 = koa.COUNTER.n
    with pytest.raises(ValueError, match="16-byte"):
        koa.outer_accum_batched(off, dy)
    with pytest.raises(ValueError, match="16-byte"):
        koa.outer_accum_batched(x.transpose(0, 1).contiguous()
                                .transpose(0, 1), dy)  # not contiguous
    x12, dy12, _ = _up_operands(dev, 4, 40, 12, 32, seed=55)
    with pytest.raises(ValueError, match="16-byte"):
        koa.outer_accum_batched(x12, dy12)             # D = 12: 24-byte rows
    with pytest.raises(TypeError, match="two bf16 or two f32"):
        koa.outer_accum_batched(x.float(), dy)
    with pytest.raises(ValueError, match="rbits"):
        koa.outer_accum_batched(x, dy, rbits=torch.zeros(
            (4, 32, 64), dtype=torch.int32, device=dev))
    assert koa.COUNTER.n == n0


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["ff", "bp"])
@pytest.mark.parametrize("kn", [(1024, 512), (512, 1024)], ids=str)
def test_sr_matmul_batched_at_granite_training_shapes(dev, kn, role):
    """A MoE training step's FF (x (32, 1024, K) . w (32, K, N)) and BP
    (g (32, 1024, N) . w^T, trans_b) at C = 1024 rows an expert: within
    the f32 path's tolerance of the plain version, two calls bit-equal,
    one launch each."""
    k, n = kn
    g = torch.Generator(device=dev).manual_seed(56)
    w = (torch.randn((32, k, n), generator=g, device=dev)
         * k ** -0.5).bfloat16()
    a = torch.randn((32, 1024, k if role == "ff" else n), generator=g,
                    device=dev).bfloat16()
    trans_b = role == "bp"
    if trans_b:
        w = w * (k / n) ** 0.5                    # dX sums n terms
    b0 = kmm.BATCHED_COUNTER.n
    got = kmm.sr_matmul_batched(a, w, trans_b=trans_b)
    assert kmm.BATCHED_COUNTER.n == b0 + 1
    assert torch.equal(got, kmm.sr_matmul_batched(a, w, trans_b=trans_b))
    torch.testing.assert_close(got, kmm.sr_matmul_batched_plain(
        a, w, trans_b=trans_b), rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_w", [False, True])
@pytest.mark.parametrize("ecdf", [(32, 1024, 1024, 512), (4, 40, 64, 32)],
                         ids=str)
def test_pe_batched_matmul_function_runs_the_kernels(dev, ecdf, transpose_w):
    """pe_dot of a 3-D table under an SR word on the cuda backend: FF one
    sr_matmul_batched launch, BP one with trans_b flipped, UP one
    outer_accum_batched launch with the bits the entropy hook gives;
    y, dX within the f32 path's tolerance of the plain versions, dW
    bit-equal to the plain SR cast of the batched kernel's own f32 dW."""
    from repro_torch.core.phases import Phase
    from repro_torch.core.program import PEWord
    from repro_torch.engine.dispatch import pe_dot
    e, c, d, f = ecdf
    g = torch.Generator(device=dev).manual_seed(57)
    x = torch.randn((e, c, d), generator=g, device=dev).bfloat16()
    w = (torch.randn((e, f, d) if transpose_w else (e, d, f), generator=g,
                     device=dev) * d ** -0.5).bfloat16()
    ct = (torch.randn((e, c, f), generator=g, device=dev)
          * c ** -0.5).bfloat16()
    rb = _up_bits(g, dev, tuple(w.shape), "sr")
    seen = []

    def entropy(op, dyt):
        seen.append(tuple(dyt.shape))
        return rb

    before = {"mm": kmm.BATCHED_COUNTER.n, "up": koa.BATCHED_COUNTER.n,
              "generic": kmm.PATH_COUNTERS["generic"].n}
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = pe_dot(xr, wr, word=PEWord(op="moe_experts_in",
                                   update_rounding="sr"),
               backend="cuda", transpose_w=transpose_w, phase=Phase.FF,
               entropy=entropy)
    dx, dw = torch.autograd.grad(y, (xr, wr), grad_outputs=ct)
    torch.cuda.synchronize()
    assert kmm.BATCHED_COUNTER.n - before["mm"] == 2
    assert koa.BATCHED_COUNTER.n - before["up"] == 1
    assert kmm.PATH_COUNTERS["generic"].n == before["generic"]
    assert seen == [(e, c, d) if transpose_w else (e, c, f)]
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), kmm.sr_matmul_batched_plain(
        x, w, trans_b=transpose_w).bfloat16().float(), rtol=2e-2, atol=2e-3)
    torch.testing.assert_close(dx.float(), kmm.sr_matmul_batched_plain(
        ct, w, trans_b=not transpose_w).bfloat16().float(), rtol=2e-2,
        atol=2e-3)
    xt, dyt = (ct, x) if transpose_w else (x, ct)
    assert torch.equal(dw.view(torch.int16), sr_cast_bf16(
        koa.outer_accum_batched(xt, dyt), rb).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_w", [False, True])
@pytest.mark.parametrize("ecdf", [(32, 1024, 1024, 512), (4, 40, 64, 32),
                                  (3, 37, 72, 40)], ids=str)
def test_pe_batched_matmul_runs_an_f32_word_on_the_f32_kernels(
        dev, ecdf, transpose_w):
    """pe_dot of a 3-D table under an f32 word (the fp32 preset) on the
    cuda backend: FF one f32 sr_matmul_batched launch, BP one with
    trans_b flipped, UP one f32 outer_accum_batched launch (no SR), none
    on sm90 or generic; y, dX and dW within the f32 path's tolerance of
    the plain versions."""
    from repro_torch.core.phases import Phase
    from repro_torch.core.program import PEWord
    from repro_torch.engine.dispatch import pe_dot
    e, c, d, f = ecdf
    g = torch.Generator(device=dev).manual_seed(59)
    x = torch.randn((e, c, d), generator=g, device=dev)
    w = (torch.randn((e, f, d) if transpose_w else (e, d, f), generator=g,
                     device=dev) * d ** -0.5)
    ct = torch.randn((e, c, f), generator=g, device=dev) * c ** -0.5
    before = {"mm": kmm.BATCHED_COUNTER.n, "up": koa.BATCHED_COUNTER.n,
              **{f"mm:{k}": v.n for k, v in kmm.PATH_COUNTERS.items()},
              **{f"up:{k}": v.n for k, v in koa.PATH_COUNTERS.items()}}
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = pe_dot(xr, wr, word=PEWord(op="moe_experts_in", ff_dtype="float32",
                                   bp_dtype="float32",
                                   update_rounding="nearest"),
               backend="cuda", transpose_w=transpose_w, phase=Phase.FF)
    dx, dw = torch.autograd.grad(y, (xr, wr), grad_outputs=ct)
    torch.cuda.synchronize()
    moved = {"mm": kmm.BATCHED_COUNTER.n - before["mm"],
             "up": koa.BATCHED_COUNTER.n - before["up"],
             **{f"mm:{k}": v.n - before[f"mm:{k}"]
                for k, v in kmm.PATH_COUNTERS.items()},
             **{f"up:{k}": v.n - before[f"up:{k}"]
                for k, v in koa.PATH_COUNTERS.items()}}
    assert moved == {"mm": 2, "up": 1, "mm:f32": 2, "mm:sm90": 0,
                     "mm:generic": 0, "up:f32": 1, "up:sm90": 0,
                     "up:generic": 0}
    assert y.dtype == dx.dtype == dw.dtype == torch.float32
    torch.testing.assert_close(y, kmm.sr_matmul_batched_plain(
        x, w, trans_b=transpose_w), rtol=MM_RTOL, atol=MM_ATOL)
    torch.testing.assert_close(dx, kmm.sr_matmul_batched_plain(
        ct, w, trans_b=not transpose_w), rtol=MM_RTOL, atol=MM_ATOL)
    xt, dyt = (ct, x) if transpose_w else (x, ct)
    torch.testing.assert_close(dw, koa.outer_accum_batched_plain(xt, dyt),
                               rtol=MM_RTOL, atol=MM_ATOL)


# ---------------------------------------------------------------------------
# The f32 batched mode: an expert table's products under the fp32 preset,
# one launch of sgemm_sm90.cuh's BATCHED form
# ---------------------------------------------------------------------------


def _f32_operands(dev, shapes, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev) * sc for s, sc in shapes]


def _mm_counts():
    return {name: c.n for name, c in (("all", kmm.COUNTER),
                                      ("batched", kmm.BATCHED_COUNTER),
                                      *kmm.PATH_COUNTERS.items())}


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("kn", [(1024, 512), (512, 1024), (72, 40),
                                (333, 97)], ids=str)
@pytest.mark.parametrize("m", [1, 8, 37, 40, 130])
@pytest.mark.parametrize("e", [1, 4, 32])
def test_sr_matmul_batched_f32_kernel_matches_plain(dev, e, m, kn, trans_b):
    """f32 operands: one launch a call on the f32 path, counted on
    sr_matmul, sr_matmul:f32 and sr_matmul:batched; each expert within
    the f32 path's tolerance of the plain version, at ragged C, K and N
    (K = 333: rows that are not 16-byte multiples)."""
    k, n = kn
    a, b = _f32_operands(dev, [((e, m, k), 1.0),
                               ((e, n, k) if trans_b else (e, k, n),
                                k ** -0.5)], seed=70)
    before = _mm_counts()
    got = kmm.sr_matmul_batched(a, b, trans_b=trans_b)
    moved = {k_: v - before[k_] for k_, v in _mm_counts().items()}
    assert moved == {"all": 1, "batched": 1, "sm90": 0, "generic": 0,
                     "f32": 1}
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, m, n)
    torch.testing.assert_close(got, kmm.sr_matmul_batched_plain(
        a, b, trans_b=trans_b), rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("emnk", [(32, 8, 512, 1024), (32, 40, 512, 1024),
                                  (3, 37, 72, 2000), (32, 1024, 512, 1024)],
                         ids=str)
def test_sr_matmul_batched_f32_kernel_two_calls_bit_equal(dev, emnk,
                                                          trans_b):
    """Two calls give the same bits; all but the C = 1024 case take a
    split-K plan (every expert's partials summed in split order by the
    last block of its tile), which must match the plain version too."""
    e, m, n, k = emnk
    p = kmm.f32_plan(m, n, k, experts=e)
    assert (p.splits > 1) == (m != 1024)
    a, b = _f32_operands(dev, [((e, m, k), 1.0),
                               ((e, n, k) if trans_b else (e, k, n),
                                k ** -0.5)], seed=71)
    first = kmm.sr_matmul_batched(a, b, trans_b=trans_b)
    assert torch.equal(first.view(torch.int32), kmm.sr_matmul_batched(
        a, b, trans_b=trans_b).view(torch.int32))
    torch.testing.assert_close(first, kmm.sr_matmul_batched_plain(
        a, b, trans_b=trans_b), rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("k", [72, 2000])
def test_sr_matmul_batched_f32_kernel_reads_no_other_expert(dev, trans_b, k):
    """Expert 1's operands are all inf: a tile of expert 0 or 2 that read
    across a boundary, or a split that summed another expert's partial
    (K = 2000 splits), would turn its outputs inf or NaN."""
    e, m, n = 3, 40, 72
    assert (kmm.f32_plan(m, n, k, experts=e).splits > 1) == (k == 2000)
    a, b = _f32_operands(dev, [((e, m, k), 1.0),
                               ((e, n, k) if trans_b else (e, k, n),
                                k ** -0.5)], seed=72)
    a[1] = float("inf")
    b[1] = float("inf")
    got = kmm.sr_matmul_batched(a, b, trans_b=trans_b)
    want = kmm.sr_matmul_batched_plain(a, b, trans_b=trans_b)
    for i in (0, 2):
        assert torch.isfinite(got[i]).all()
        torch.testing.assert_close(got[i], want[i], rtol=MM_RTOL,
                                   atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 0.25])
@pytest.mark.parametrize("df", [(1024, 512), (512, 1024), (72, 40)],
                         ids=str)
@pytest.mark.parametrize("t", [1, 8, 37, 1024])
@pytest.mark.parametrize("e", [1, 4, 32])
def test_outer_accum_batched_f32_kernel_matches_plain(dev, e, t, df, scale):
    """f32 operands: one launch a call on the f32 path, counted on
    outer_accum, outer_accum:f32 and outer_accum:batched; dW with its
    scale within the f32 path's tolerance of the plain version, at
    ragged token counts."""
    d, f = df
    x, dy = _f32_operands(dev, [((e, t, d), 1.0),
                                ((e, t, f), max(t, 1) ** -0.5)], seed=73)
    before = _oa_counts()
    got = koa.outer_accum_batched(x, dy, scale=scale)
    moved = {k: v - before[k] for k, v in _oa_counts().items()}
    assert moved == {"all": 1, "batched": 1, "sm90": 0, "generic": 0,
                     "f32": 1}
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, d, f)
    torch.testing.assert_close(got, koa.outer_accum_batched_plain(
        x, dy, scale=scale), rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("etdf", [(32, 1024, 1024, 512), (2, 4096, 64, 64),
                                  (3, 2000, 72, 40)], ids=str)
def test_outer_accum_batched_f32_kernel_two_calls_bit_equal(dev, etdf):
    """Two calls give the same bits; the 4096- and 2000-token cases take
    a split of the tokens, which must match the plain version too."""
    e, t, d, f = etdf
    p = koa.batched_f32_plan(e, t, d, f)
    assert (p.splits > 1) == (t != 1024)
    x, dy = _f32_operands(dev, [((e, t, d), 1.0), ((e, t, f), t ** -0.5)],
                          seed=74)
    first = koa.outer_accum_batched(x, dy, scale=0.5)
    assert torch.equal(first.view(torch.int32), koa.outer_accum_batched(
        x, dy, scale=0.5).view(torch.int32))
    torch.testing.assert_close(first, koa.outer_accum_batched_plain(
        x, dy, scale=0.5), rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
def test_f32_batched_kernels_raise_on_what_they_do_not_take(dev):
    """Non-contiguous or mixed-dtype operands, and SR bits with f32
    operands, raise with no launch."""
    a, b = _f32_operands(dev, [((4, 8, 64), 1.0), ((4, 64, 32), 0.1)],
                         seed=75)
    x, dy = _f32_operands(dev, [((4, 40, 64), 1.0), ((4, 40, 32), 0.1)],
                          seed=76)
    n0, u0 = kmm.COUNTER.n, koa.COUNTER.n
    strided = a.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kmm.sr_matmul_batched(strided, b)
    with pytest.raises(TypeError, match="two bf16 or two f32"):
        kmm.sr_matmul_batched(a, b.bfloat16())
    with pytest.raises(TypeError, match="two bf16 or two f32"):
        kmm.sr_matmul_batched(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        koa.outer_accum_batched(x.transpose(0, 1).contiguous()
                                .transpose(0, 1), dy)
    with pytest.raises(TypeError, match="two bf16 or two f32"):
        koa.outer_accum_batched(x.bfloat16(), dy)
    with pytest.raises(ValueError, match="no rbits"):
        koa.outer_accum_batched(x, dy, rbits=torch.zeros(
            (4, 64, 32), dtype=torch.int32, device=dev))
    assert (kmm.COUNTER.n, koa.COUNTER.n) == (n0, u0)


@pytest.mark.cuda
def test_tied_head_at_granite_vocab_trains_on_the_sm90_path(dev):
    """granite's tied head (V = 49155, odd) in a training word: FF reads
    the table K-major, BP and UP read the (T, V) logits' gradient, whose
    rows no TMA map describes until kmm.operand pads them to 49160; all
    three run on sm90, none on generic, and dX / dW (SR from the hook's
    bits) match the plain versions."""
    from repro_torch.core.phases import Phase
    from repro_torch.core.program import PEWord
    from repro_torch.engine.dispatch import pe_dot
    V, d, T = 49155, 1024, 256
    g = torch.Generator(device=dev).manual_seed(58)
    x = torch.randn((T, d), generator=g, device=dev).bfloat16()
    table = (torch.randn((V, d), generator=g, device=dev) * 0.02).bfloat16()
    ct = (torch.randn((T, V), generator=g, device=dev) * V ** -0.5).bfloat16()
    rb = _up_bits(g, dev, (V, d), "sr")
    before = {**{f"mm:{k}": c.n for k, c in kmm.PATH_COUNTERS.items()},
              **{f"up:{k}": c.n for k, c in koa.PATH_COUNTERS.items()}}
    xr, tr = x.clone().requires_grad_(), table.clone().requires_grad_()
    y = pe_dot(xr, tr, word=PEWord(op="lm_head", update_rounding="sr"),
               backend="cuda", transpose_w=True, phase=Phase.FF,
               entropy=lambda op, dyt: rb)
    dx, dw = torch.autograd.grad(y, (xr, tr), grad_outputs=ct)
    torch.cuda.synchronize()
    moved = {k: c.n - before[f"mm:{k}"] for k, c in kmm.PATH_COUNTERS.items()}
    assert moved == {"sm90": 2, "generic": 0, "f32": 0}
    moved = {k: c.n - before[f"up:{k}"] for k, c in koa.PATH_COUNTERS.items()}
    assert moved == {"sm90": 1, "generic": 0, "f32": 0}
    torch.testing.assert_close(dx.float(), kmm.sr_matmul_plain(
        ct, table).bfloat16().float(), rtol=2e-2, atol=2e-3)
    assert torch.equal(dw.view(torch.int16), sr_cast_bf16(
        koa.outer_accum(kmm.operand(ct), x), rb).view(torch.int16))


# ---------------------------------------------------------------------------
# The bf16 batched forms' live rows: each expert's count of kept entries
# (models/moe.py::_expert_rows) lets sr_matmul_batched skip the dead row
# tiles and outer_accum_batched stop its token reduction at the count;
# the results equal the all-live kernel's up to the sign of a zero
# (torch.equal takes -0 == +0)
# ---------------------------------------------------------------------------

# an expert's kept entries at every edge of a 64-token block and a
# 128-row tile, with an empty expert and a full one (C) at the end
LIVE_COUNTS = (0, 1, 63, 64, 65, 127, 128, 129)


def _dispatched(dev, C, widths, seed, counts=LIVE_COUNTS,
                dtype=torch.bfloat16):
    """Buffers built by the MoE dispatch (models/moe.py) for experts with
    `counts` + (C,) routed entries: one (E, C, w) buffer of `dtype` per
    width in `widths`, each expert's rows past its count zero, and rows
    (E,) int32 from _expert_rows."""
    from repro_torch.models import moe
    counts = (*counts, C)
    E = len(counts)
    g = torch.Generator(device=dev).manual_seed(seed)
    experts = torch.cat([torch.full((c,), i, dtype=torch.int64, device=dev)
                         for i, c in enumerate(counts)])
    experts = experts[torch.randperm(experts.numel(), generator=g,
                                     device=dev)]
    slot, keep = moe._dispatch_indices(experts, E, C)
    rows = moe._expert_rows(experts, E, C)
    bufs = []
    for w in widths:
        src = torch.randn((experts.numel(), w), generator=g, device=dev)
        buf = torch.zeros((E * C + 1, w), device=dev)
        buf.index_copy_(0, slot, src * keep[:, None])
        bufs.append(buf[:-1].reshape(E, C, w).to(dtype).contiguous())
    assert rows.tolist() == list(counts)
    return bufs, rows, g


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True], ids=["ff", "bp"])
@pytest.mark.parametrize("kn", [(1024, 512), (64, 96)], ids=str)
def test_sr_matmul_batched_live_rows_match_plain_and_all_live(dev, kn,
                                                             trans_b):
    """sr_matmul_batched with each expert's live rows, at counts on every
    tile edge (C = 200: a ragged last tile): f32 out within the f32
    path's tolerance of the plain version; f32 and bf16 out equal to the
    all-live kernel's; the bf16 out bit-equal to the f32 out rounded to
    nearest even; one launch each."""
    k, n = kn
    (a,), rows, g = _dispatched(dev, 200, [n if trans_b else k], seed=80)
    E = a.shape[0]
    w = (torch.randn((E, k, n), generator=g, device=dev)
         * a.shape[2] ** -0.5).bfloat16()
    b0 = kmm.BATCHED_COUNTER.n
    got = kmm.sr_matmul_batched(a, w, trans_b=trans_b, rows=rows)
    got16 = kmm.sr_matmul_batched(a, w, trans_b=trans_b, rows=rows,
                                  out_dtype=torch.bfloat16)
    assert kmm.BATCHED_COUNTER.n == b0 + 2
    assert got.dtype == torch.float32 and got16.dtype == torch.bfloat16
    torch.testing.assert_close(got, kmm.sr_matmul_batched_plain(
        a, w, trans_b=trans_b, rows=rows), rtol=MM_RTOL, atol=MM_ATOL)
    assert torch.equal(got, kmm.sr_matmul_batched(a, w, trans_b=trans_b))
    assert torch.equal(got16, kmm.sr_matmul_batched(
        a, w, trans_b=trans_b, out_dtype=torch.bfloat16))
    assert torch.equal(got16.view(torch.int16),
                       got.to(torch.bfloat16).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "sr"])
@pytest.mark.parametrize("df", [(1024, 512), (72, 40)], ids=str)
def test_outer_accum_batched_live_rows_match_plain_and_all_live(dev, df,
                                                                mode):
    """outer_accum_batched with each expert's live tokens: the reduction
    stops at ceil(count / 64) token blocks (an empty expert's dW is 0).
    f32 within the tolerance of the plain version and equal to the
    all-live kernel's; SR bit-equal to the plain SR cast of its own f32
    result and to the all-live kernel's SR result."""
    d, f = df
    (x, dy), rows, g = _dispatched(dev, 200, [d, f], seed=81)
    dy = (dy.float() * 200 ** -0.5).bfloat16()
    got = koa.outer_accum_batched(x, dy, rows=rows)
    torch.testing.assert_close(got, koa.outer_accum_batched_plain(
        x, dy, rows=rows), rtol=MM_RTOL, atol=MM_ATOL)
    assert torch.equal(got, koa.outer_accum_batched(x, dy))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    if mode == "sr":
        rb = _up_bits(g, dev, tuple(got.shape), "sr")
        sr = koa.outer_accum_batched(x, dy, rbits=rb, rows=rows)
        assert torch.equal(sr.view(torch.int16),
                           sr_cast_bf16(got, rb).view(torch.int16))
        assert torch.equal(sr, koa.outer_accum_batched(x, dy, rbits=rb))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ff:f32", "ff:bf16", "bp:bf16", "up:f32",
                                  "up:sr"])
def test_batched_kernels_write_every_element_with_live_rows(dev, case):
    """The output's block is first filled with NaN (the caching allocator
    hands the kernel that block again): every element comes back
    finite, the rows past an expert's live tile exactly 0 (FF / BP: the
    dead row tiles' zeros; UP: every dW element, an empty expert's
    too)."""
    role, kind = case.split(":")
    C, k, n = 200, 1024, 512
    if role == "up":
        (x, dy), rows, g = _dispatched(dev, C, [k, n], seed=82)
        rb = _up_bits(g, dev, (x.shape[0], k, n), "sr") if kind == "sr" \
            else None
        shape, dt = (x.shape[0], k, n), (torch.bfloat16 if rb is not None
                                         else torch.float32)
        call = lambda: koa.outer_accum_batched(x, dy, rbits=rb, rows=rows)
    else:
        trans_b = role == "bp"
        (a,), rows, g = _dispatched(dev, C, [n if trans_b else k], seed=82)
        w = (torch.randn((a.shape[0], k, n), generator=g, device=dev)
             * a.shape[2] ** -0.5).bfloat16()
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        shape = (a.shape[0], C, k if trans_b else n)
        call = lambda: kmm.sr_matmul_batched(a, w, trans_b=trans_b,
                                             rows=rows, out_dtype=dt)
    poison = torch.full(shape, float("nan"), dtype=dt, device=dev)
    ptr = poison.data_ptr()
    del poison
    got = call()
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr, "the allocator did not reuse the block"
    assert torch.isfinite(got.float()).all()
    if role != "up":
        live = kmm.live_rows(rows, C)
        assert torch.equal(got[~live].float(),
                           torch.zeros_like(got[~live].float()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("ff", 2, 8, 64, 4096), ("bp", 2, 8, 64, 4096),
                                  ("ff", 32, 8, 512, 1024),
                                  ("ff", 32, 40, 1024, 512),
                                  ("bp", 32, 40, 1024, 512),
                                  ("up", 2, 4096, 64, 64),
                                  ("up", 32, 40, 1024, 512)], ids=str)
def test_batched_kernels_with_live_rows_two_calls_bit_equal(dev, case):
    """Split-K plans ((2, 8, 64, 4096) FF / BP, (2, 4096, 64, 64) UP:
    partials summed in split order, the dead row tiles zeroed by the
    sum) and granite's short tables (C = 8, 40) with live rows below C:
    two calls give the same bits, equal to the all-live kernel's."""
    role, e, c, n, k = case
    g = torch.Generator(device=dev).manual_seed(83)
    rows = torch.randint(0, c + 1, (e,), generator=g, device=dev,
                         dtype=torch.int32)
    live = kmm.live_rows(rows, c)[..., None]
    if role == "up":
        x = torch.where(live, torch.randn((e, c, n), generator=g,
                                          device=dev), 0.0).bfloat16()
        dy = torch.where(live, torch.randn((e, c, k), generator=g,
                                           device=dev), 0.0).bfloat16()
        rb = _up_bits(g, dev, (e, n, k), "sr")
        assert (koa.batched_plan(e, c, n, k).splits > 1) == (c == 4096)
        first = koa.outer_accum_batched(x, dy, rbits=rb, rows=rows)
        assert torch.equal(first, koa.outer_accum_batched(x, dy, rbits=rb,
                                                          rows=rows))
        assert torch.equal(first, koa.outer_accum_batched(x, dy, rbits=rb))
        return
    trans_b = role == "bp"
    a = torch.where(live, torch.randn((e, c, k), generator=g, device=dev),
                    0.0).bfloat16()
    w = (torch.randn((e, n, k) if trans_b else (e, k, n), generator=g,
                     device=dev) * k ** -0.5).bfloat16()
    p = kmm.plan(c, n, k, "k", "k" if trans_b else "n", experts=e)
    assert (p.splits > 1) == (k == 4096)
    for dt in (torch.float32, torch.bfloat16):
        first = kmm.sr_matmul_batched(a, w, trans_b=trans_b, rows=rows,
                                      out_dtype=dt)
        assert torch.equal(first, kmm.sr_matmul_batched(
            a, w, trans_b=trans_b, rows=rows, out_dtype=dt))
        assert torch.equal(first, kmm.sr_matmul_batched(
            a, w, trans_b=trans_b, out_dtype=dt))
    torch.testing.assert_close(first.float(), kmm.sr_matmul_batched_plain(
        a, w, trans_b=trans_b, rows=rows), rtol=2e-2, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_w", [False, True])
def test_pe_batched_matmul_with_live_rows_equals_all_live(dev, transpose_w):
    """pe_dot of an expert table on the cuda backend with the dispatch's
    live rows and without: y, dX and the SR dW (the hook's bits) equal,
    bf16 out of FF and BP written by the kernel (no cast launch)."""
    from repro_torch.core.phases import Phase
    from repro_torch.core.program import PEWord
    from repro_torch.engine.dispatch import pe_dot
    d, f = 1024, 512
    (x, ct), rows, g = _dispatched(dev, 200, [d, f], seed=84)
    E = x.shape[0]
    w = (torch.randn((E, f, d) if transpose_w else (E, d, f), generator=g,
                     device=dev) * d ** -0.5).bfloat16()
    rb = _up_bits(g, dev, tuple(w.shape), "sr")
    word = PEWord(op="moe_experts_in", update_rounding="sr")
    res = []
    for r in (rows, None):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = pe_dot(xr, wr, word=word, backend="cuda",
                   transpose_w=transpose_w, phase=Phase.FF,
                   entropy=lambda op, dyt: rb, rows=r)
        res.append((y, *torch.autograd.grad(y, (xr, wr), grad_outputs=ct)))
    for got, want in zip(*res):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The f32 batched forms' live rows (the fp32 preset on a MoE table):
# sgemm_sm90_batched.cuh computes only the live row tiles of FF and BP
# and stops the UP's token loop at each expert's count; the results
# equal the all-live kernel's up to the sign of a zero
# ---------------------------------------------------------------------------

# an expert's kept entries at every edge of a 16-token block, a 64-row
# span and a 128-row tile, with an empty expert and a full one (C)
F32_LIVE_COUNTS = (0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129)


def _f32_role(dev, role, C, k, n, seed, counts=F32_LIVE_COUNTS):
    """(call(rows), rows, shape) of an f32 batched product on buffers
    built by the MoE dispatch: FF a (E, C, k) . w (E, k, n), BP a (E, C,
    n) . w^T, UP x (E, C, k)^T dy (E, C, n) with scale 0.5."""
    if role == "up":
        (x, dy), rows, _ = _dispatched(dev, C, [k, n], seed, counts,
                                       torch.float32)
        dy = dy * C ** -0.5
        return (lambda r: koa.outer_accum_batched(x, dy, scale=0.5, rows=r),
                lambda r: koa.outer_accum_batched_plain(x, dy, scale=0.5,
                                                        rows=r),
                rows, (x.shape[0], k, n))
    trans_b = role == "bp"
    (a,), rows, g = _dispatched(dev, C, [n if trans_b else k], seed, counts,
                                torch.float32)
    w = torch.randn((a.shape[0], k, n), generator=g, device=dev) \
        * a.shape[2] ** -0.5
    return (lambda r: kmm.sr_matmul_batched(a, w, trans_b=trans_b, rows=r),
            lambda r: kmm.sr_matmul_batched_plain(a, w, trans_b=trans_b,
                                                  rows=r),
            rows, (a.shape[0], C, k if trans_b else n))


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["ff", "bp", "up"])
@pytest.mark.parametrize("ckn", [(1024, 1024, 512), (1024, 512, 1024),
                                 (200, 72, 40), (300, 33, 130)], ids=str)
def test_f32_batched_live_rows_match_plain_and_all_live(dev, role, ckn):
    """The f32 batched kernels with each expert's live rows, at counts on
    every edge of a 16-token block and a 128-row tile, an empty expert
    and a full one: within the f32 path's tolerance of the plain version,
    equal to the all-live kernel's on the same buffers, one f32 launch a
    call; an empty expert's output 0."""
    C, k, n = ckn
    call, plain, rows, _ = _f32_role(dev, role, C, k, n, seed=90)
    mod = koa if role == "up" else kmm
    before = {name: c.n for name, c in (("batched", mod.BATCHED_COUNTER),
                                        *mod.PATH_COUNTERS.items())}
    got = call(rows)
    moved = {name: c.n - before[name] for name, c in (
        ("batched", mod.BATCHED_COUNTER), *mod.PATH_COUNTERS.items())}
    assert moved == {"batched": 1, "f32": 1, "sm90": 0, "generic": 0}
    torch.testing.assert_close(got, plain(rows), rtol=MM_RTOL, atol=MM_ATOL)
    assert torch.equal(got, call(None))
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["ff", "bp", "up"])
def test_f32_batched_kernels_write_every_element_with_live_rows(dev, role):
    """The output's block is first filled with NaN (the caching allocator
    hands the kernel that block again): every element comes back finite,
    FF / BP's rows past an expert's count exactly 0 (the dead row tiles'
    zeros and the live tiles' zero rows), the UP's empty expert 0."""
    C = 200
    call, _, rows, shape = _f32_role(dev, role, C, 1024, 512, seed=91)
    poison = torch.full(shape, float("nan"), device=dev)
    ptr = poison.data_ptr()
    del poison
    got = call(rows)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr, "the allocator did not reuse the block"
    assert torch.isfinite(got).all()
    if role == "up":
        assert torch.equal(got[0], torch.zeros_like(got[0]))
    else:
        dead = ~kmm.live_rows(rows, C)
        assert torch.equal(got[dead], torch.zeros_like(got[dead]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("ff", 32, 8, 512, 1024),
                                  ("bp", 32, 8, 512, 1024),
                                  ("ff", 32, 40, 512, 1024),
                                  ("bp", 32, 40, 512, 1024),
                                  ("up", 32, 40, 1024, 512),
                                  ("up", 2, 4096, 64, 64)], ids=str)
def test_f32_batched_split_plans_with_live_rows_two_calls_bit_equal(dev,
                                                                    case):
    """granite's 512-wide products at C = 8, 40 (FF / BP plans split K),
    its UP at C = 40 and a long UP ((2, 4096, 64, 64): its plan splits
    the tokens) with live
    rows below C: two calls give the same bits, equal to the all-live
    kernel's and within tolerance of the plain version."""
    role, e, c, n, k = case
    g = torch.Generator(device=dev).manual_seed(92)
    rows = torch.randint(0, c + 1, (e,), generator=g, device=dev,
                         dtype=torch.int32)
    live = kmm.live_rows(rows, c)[..., None]
    if role == "up":
        x = torch.where(live, torch.randn((e, c, n), generator=g,
                                          device=dev), 0.0)
        dy = torch.where(live, torch.randn((e, c, k), generator=g,
                                           device=dev), 0.0)
        assert (koa.batched_f32_plan(e, c, n, k).splits > 1) == (c == 4096)
        call = lambda r: koa.outer_accum_batched(x, dy, scale=1 / c, rows=r)
        want = koa.outer_accum_batched_plain(x, dy, scale=1 / c, rows=rows)
    else:
        trans_b = role == "bp"
        a = torch.where(live, torch.randn((e, c, k), generator=g,
                                          device=dev), 0.0)
        w = torch.randn((e, n, k) if trans_b else (e, k, n), generator=g,
                        device=dev) * k ** -0.5
        assert kmm.f32_plan(c, n, k, experts=e).splits > 1
        call = lambda r: kmm.sr_matmul_batched(a, w, trans_b=trans_b,
                                               rows=r)
        want = kmm.sr_matmul_batched_plain(a, w, trans_b=trans_b, rows=rows)
    first = call(rows)
    assert torch.equal(first.view(torch.int32), call(rows).view(torch.int32))
    assert torch.equal(first, call(None))
    torch.testing.assert_close(first, want, rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["ff", "bp", "up"])
@pytest.mark.parametrize("k", [72, 2000])
def test_f32_batched_live_rows_read_no_other_expert(dev, role, k):
    """Expert 1's operands are all inf (its live rows and its dead ones,
    the contract's zeros broken on purpose): a unit of expert 0 or 2 that
    read across a boundary, or a split that summed another expert's
    partial (K = 2000 splits), would turn its outputs inf or NaN."""
    e, m, n = 3, 40, 72
    rows = torch.tensor([17, 33, 40], dtype=torch.int32, device=dev)
    live = kmm.live_rows(rows, m)[..., None]
    g = torch.Generator(device=dev).manual_seed(93)
    if role == "up":
        x = torch.where(live, torch.randn((e, m, n), generator=g,
                                          device=dev), 0.0)
        dy = torch.where(live, torch.randn((e, m, k), generator=g,
                                           device=dev), 0.0) * m ** -0.5
        x[1], dy[1] = float("inf"), float("inf")
        got = koa.outer_accum_batched(x, dy, rows=rows)
        want = koa.outer_accum_batched_plain(x, dy, rows=rows)
    else:
        trans_b = role == "bp"
        a = torch.where(live, torch.randn((e, m, k), generator=g,
                                          device=dev), 0.0)
        b = torch.randn((e, n, k) if trans_b else (e, k, n), generator=g,
                        device=dev) * k ** -0.5
        a[1], b[1] = float("inf"), float("inf")
        got = kmm.sr_matmul_batched(a, b, trans_b=trans_b, rows=rows)
        want = kmm.sr_matmul_batched_plain(a, b, trans_b=trans_b, rows=rows)
    for i in (0, 2):
        assert torch.isfinite(got[i]).all()
        torch.testing.assert_close(got[i], want[i], rtol=MM_RTOL,
                                   atol=MM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_w", [False, True])
def test_pe_f32_batched_matmul_with_live_rows_equals_all_live(dev,
                                                             transpose_w):
    """pe_dot of an f32 expert table under an fp32 word on the cuda
    backend, with the dispatch's live rows and without: y, dX and dW
    equal, every launch on the f32 path."""
    from repro_torch.core.phases import Phase
    from repro_torch.core.program import PEWord
    from repro_torch.engine.dispatch import pe_dot
    d, f = 1024, 512
    (x, ct), rows, g = _dispatched(dev, 200, [d, f], seed=94,
                                   dtype=torch.float32)
    E = x.shape[0]
    w = torch.randn((E, f, d) if transpose_w else (E, d, f), generator=g,
                    device=dev) * d ** -0.5
    word = PEWord(op="moe_experts_in", ff_dtype="float32",
                  bp_dtype="float32")
    res = []
    before = (kmm.PATH_COUNTERS["f32"].n, koa.PATH_COUNTERS["f32"].n)
    for r in (rows, None):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = pe_dot(xr, wr, word=word, backend="cuda",
                   transpose_w=transpose_w, phase=Phase.FF, rows=r)
        res.append((y, *torch.autograd.grad(y, (xr, wr), grad_outputs=ct)))
    assert (kmm.PATH_COUNTERS["f32"].n - before[0],
            koa.PATH_COUNTERS["f32"].n - before[1]) == (4, 2)
    for got, want in zip(*res):
        assert got.dtype == torch.float32
        assert torch.equal(got, want)



# ---------------------------------------------------------------------------
# selective_scan (Mamba's recurrence; no TPU kernel)
# ---------------------------------------------------------------------------

SCAN_REL = 1e-5


def _scan_case(dev, B, S, di, N, xdtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, di), generator=g, device=dev).to(xdtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, di), generator=g, device=dev) - 1.0)
    A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).repeat(
        di, 1) * (0.5 + torch.rand((di, N), generator=g, device=dev))
    Bm = torch.randn((B, S, N), generator=g, device=dev)
    Cm = torch.randn((B, S, N), generator=g, device=dev)
    D = 0.5 + torch.rand(di, generator=g, device=dev)
    h0 = 0.5 * torch.randn((B, di, N), generator=g, device=dev)
    return x, dt, A, Bm, Cm, D, h0


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [(1, 1, 8192, 16), (1, 7, 8192, 16),
                                  (1, 32, 8192, 16), (1, 512, 8192, 16),
                                  (32, 1, 8192, 16), (3, 45, 100, 4),
                                  (2, 33, 96, 8), (4, 256, 8192, 16)])
def test_selective_scan_kernel_matches_plain(dev, case, xdtype):
    """jamba's shapes (di 8192, N 16: a decode step of 32 slots, chunks
    of one slot, training's forward of 4 x 256) and ragged ones (di not
    a multiple of the block, N 4 and 8), from a nonzero state, bit-equal
    twice, `active` honoured."""
    B, S, di, N = case
    x, dt, A, Bm, Cm, D, h0 = _scan_case(dev, B, S, di, N, xdtype)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[B // 2] = B == 1
    kss.COUNTER.reset()
    st = h0.clone()
    y, _ = kss.selective_scan(x, dt, A, Bm, Cm, D, st, active=active)
    assert kss.COUNTER.n == 1
    yp, hp = kss.selective_scan_plain(x, dt, A, Bm, Cm, D, h0)
    torch.cuda.synchronize()
    assert (y - yp).abs().max() <= SCAN_REL * yp.abs().max()
    want = torch.where(active[:, None, None], hp, h0)
    assert (st - want).abs().max() <= SCAN_REL * hp.abs().max()
    st2 = h0.clone()
    y2, _ = kss.selective_scan(x, dt, A, Bm, Cm, D, st2, active=active)
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [9, 37])
@pytest.mark.parametrize("di", [256, 300])
@pytest.mark.parametrize("N", [4, 8, 16])
def test_selective_scan_kernel_chunk_equals_single_steps(dev, N, di, S):
    """A chunk of 9 tokens (2 groups of 4 and one alone) or 37 (over
    several tiles) and as many single-token calls continuing the state
    give the same bits: every token's arithmetic is the same, whatever
    block and tile the plan gives a chunk and a step.  di 300 is not a
    multiple of any plan's channels a block."""
    if di == 300:
        assert all(di % p.channels for p in (
            kss.selective_scan_plan(2, S, di, N),
            kss.selective_scan_plan(2, 1, di, N)))
    x, dt, A, Bm, Cm, D, h0 = _scan_case(dev, 2, S, di, N,
                                         torch.bfloat16, seed=1)
    st = h0.clone()
    y, _ = kss.selective_scan(x, dt, A, Bm, Cm, D, st)
    s1, ys = h0.clone(), []
    for t in range(S):
        ys.append(kss.selective_scan(
            *(a[:, t:t + 1].contiguous() for a in (x, dt)), A,
            *(a[:, t:t + 1].contiguous() for a in (Bm, Cm)), D, s1)[0])
    assert torch.equal(torch.cat(ys, dim=1), y) and torch.equal(s1, st)


@pytest.mark.cuda
def test_selective_scan_kernel_from_zeros_and_bad_shapes(dev):
    x, dt, A, Bm, Cm, D, _ = _scan_case(dev, 2, 5, 64, 16, torch.float32)
    y, h = kss.selective_scan(x, dt, A, Bm, Cm, D)
    yp, hp = kss.selective_scan_plain(x, dt, A, Bm, Cm, D)
    assert (y - yp).abs().max() <= SCAN_REL * yp.abs().max()
    assert (h - hp).abs().max() <= SCAN_REL * hp.abs().max()
    x6, dt6, A6, B6, C6, D6, _ = _scan_case(dev, 1, 2, 64, 6, torch.float32)
    with pytest.raises(ValueError):
        kss.selective_scan(x6, dt6, A6, B6, C6, D6)


# ---------------------------------------------------------------------------
# selective_scan_bwd (the scan's gradient; no TPU kernel)
# ---------------------------------------------------------------------------

# (B, S, di, N, strong decay): jamba training's 4 x 256 and chip_smoke's
# step-0 2 x 64 at di 8192, one token, one partial tile, several tiles
# with di not a multiple of a block's channels, and dt A <= -150, where
# exp(dt A) is 0
SCAN_BWD_CASES = [(4, 256, 8192, 16, False), (2, 64, 8192, 16, False),
                  (2, 1, 256, 16, False), (3, 5, 96, 8, False),
                  (3, 45, 100, 8, False), (2, 37, 300, 4, False),
                  (2, 40, 256, 16, True), (2, 33, 200, 4, True)]
# f32 sums over n, channels and tokens against the plain version's f64
# ones: each output within this share of its own largest value
SCAN_BWD_REL = 1e-4


def _scan_bwd_case(dev, B, S, di, N, strong, xdtype, seed=0):
    x, dt, A, Bm, Cm, D, _ = _scan_case(dev, B, S, di, N, xdtype, seed)
    if strong:
        dt = dt + 300.0
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    return x, dt, A, Bm, Cm, D, torch.randn((B, S, di), generator=g,
                                            device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SCAN_BWD_CASES, ids=str)
def test_selective_scan_bwd_kernel_matches_plain(dev, case, xdtype):
    args = _scan_bwd_case(dev, *case, xdtype)
    if case[-1]:
        assert not torch.exp(args[1][..., None] * args[2]).any()
    kss.BWD_COUNTER.reset()
    got = kss.selective_scan_bwd(*args)
    torch.cuda.synchronize()
    assert kss.BWD_COUNTER.n == 1
    want = kss.selective_scan_bwd_plain(*args)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        err = float((g - w).abs().max())
        assert err <= SCAN_BWD_REL * float(w.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SCAN_BWD_CASES[:1] + SCAN_BWD_CASES[-3:],
                         ids=str)
def test_selective_scan_bwd_kernel_two_calls_bit_equal(dev, case, xdtype):
    """No float atomics: the cross-block sums of dB, dC, dA and dD run in
    a fixed order, so the same inputs give the same bits."""
    args = _scan_bwd_case(dev, *case, xdtype, seed=3)
    a, b = kss.selective_scan_bwd(*args), kss.selective_scan_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_selective_scan_train_runs_both_kernels_and_raises_what_it_refuses(
        dev):
    x, dt, A, Bm, Cm, D, dy = _scan_bwd_case(dev, 2, 40, 512, 16, False,
                                             torch.bfloat16, seed=5)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    kss.COUNTER.reset()
    kss.BWD_COUNTER.reset()
    y = kss.selective_scan_train(*leaves)
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    assert (kss.COUNTER.n, kss.BWD_COUNTER.n) == (1, 1)
    assert [g.dtype for g in grads] == [torch.bfloat16] + [torch.float32] * 5
    # the forward's and the backward's kernels, their results as they are
    # (dx rounded to x's dtype)
    assert torch.equal(y, kss.selective_scan(x, dt, A, Bm, Cm, D)[0])
    for g, want in zip(grads, kss.selective_scan_bwd(x, dt, A, Bm, Cm, D,
                                                     dy)):
        assert torch.equal(g, want.to(g.dtype))
    # d_state 6: no instantiation
    bad = _scan_bwd_case(dev, 1, 4, 64, 6, False, torch.float32)
    with pytest.raises(ValueError, match="d_state"):
        kss.selective_scan_bwd(*bad)
    # a carried state: training runs from zeros and has no gradient for it
    state = torch.zeros((2, 512, 16), device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="carried state"):
        kss.selective_scan_train(*leaves, state)


@pytest.mark.cuda
def test_mamba_block_backward_on_the_card_matches_the_reference_backend(dev):
    """One Mamba mixer (the reduced jamba's widths with jamba's d_state 16
    and d_conv 4) under the fp32 program, from no state: the gradients of
    sum(out * c) for x and every leaf on the cuda backend (f32
    sr_matmul / outer_accum, selective_scan and selective_scan_bwd)
    against the reference backend (f64 products, the plain scan and its
    plain reverse), each within 1e-4 of its largest value."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.phases import Phase
    from repro_torch.core.program import compile_program
    from repro_torch.engine import PEContext
    from repro_torch.models import ssm
    base = get_reduced("jamba-v0.1-52b")
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, d_state=16, d_conv=4))
    B, S = 2, 100
    prog = compile_program(cfg, ShapeConfig("t", S, B, "train"),
                           precision="fp32")
    g = torch.Generator(device=dev).manual_seed(6)
    params = ssm.mamba_params(cfg, g)
    params["dt_bias"].copy_(0.3 * torch.randn(params["dt_bias"].shape,
                                              generator=g, device=dev))
    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    c = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    out = {}
    for backend in ("reference", "cuda"):
        kss.BWD_COUNTER.reset()
        leaves = [x.clone().requires_grad_()] + [
            p.clone().requires_grad_() for p in params.values()]
        tp = dict(zip(params, leaves[1:]))
        y = ssm.mamba_block(cfg, leaves[0], tp,
                            PEContext(prog, backend=backend, phase=Phase.FF))
        out[backend] = torch.autograd.grad((y * c).sum(), leaves)
        assert kss.BWD_COUNTER.n == (backend == "cuda")
    for name, a, b in zip(["x", *params], out["cuda"], out["reference"]):
        assert torch.isfinite(a).all(), name
        err = float((a - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), (name, err)
