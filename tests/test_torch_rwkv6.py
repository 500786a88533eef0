"""The port's rwkv6 serving slice against the JAX package, and its own
invariants.

The port's reduced rwkv6 (2 layers, d 128, head_dim 32, d_ff 256, vocab
256) is built on the JAX side from the port's fields, so both sides run
the same model.  Inputs are made from a numpy seed.

- the kernels' plain versions against the reference's: ``wkv6`` against
  the Pallas kernel in interpret mode at its test's rtol/atol 3e-4 (from
  zeros), and against ``ssm.wkv6_scan`` from a carried state (f32
  arithmetic in another order: 1e-5); ``fused_ffn`` against the Pallas
  ``fused_ffn`` in interpret mode within the reference's own 2e-2 (bf16
  results of f32 sums in another order);
- ``rwkv_block`` with a carried state against the reference's: in f32
  within 1e-4, in bf16 within 2e-2 of the block's largest output;
- the slice teacher-forced: the reference's parameters carried across
  (``params_from_numpy``), two prompt chunks and three decode steps,
  per-op and fused, on both backends, against the reference's per-op
  decode (the cuda backend's fused decode: against the reference's fused
  Pallas words in interpret mode); logits within 2e-2 and the state
  within 6e-2 (tests/test_decode_fused.py's tolerances);
- the engine: reference-backend fused decode bit-identical to per-op,
  chunked prefill bit-identical to token-by-token decode, a re-leased
  slot's state reset, and the generated tokens against the JAX engine's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core.dataflow import MeshSpec  # noqa: E402
from repro.core.program import compile_program as jcompile  # noqa: E402
from repro.kernels import decode_fused as jdf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.layers import Sharder  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro.serving import build_engine as jbuild_engine  # noqa: E402
from repro.serving.slots import slot_bytes as jslot_bytes  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402
from repro_torch.engine.context import PEContext  # noqa: E402
from repro_torch.kernels import decode_fused as kdf  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import sr_matmul as kmm  # noqa: E402
from repro_torch.kernels import wkv6 as kwkv  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import train_loop as tl  # noqa: E402
from repro_torch.serving import Request, build_engine  # noqa: E402
from repro_torch.serving.slots import reset_slots, slot_bytes  # noqa: E402

ARCH = "rwkv6-1.6b"
MESH1 = MeshSpec(axis_sizes={"data": 1, "model": 1}, batch_axes=("data",))
WKV_TOL = 3e-4                  # tests/test_kernels.py's wkv6 tolerance
SCAN_TOL = 1e-5                 # f32 recurrence, another summation order
LOGIT_TOL, STATE_TOL = 2e-2, 6e-2


def jax_reduced():
    """The reference's rwkv6 config with the port's reduced fields."""
    ours = get_reduced(ARCH)
    full = jget_config(ARCH)
    return dataclasses.replace(
        full, n_layers=ours.n_layers, d_model=ours.d_model, d_ff=ours.d_ff,
        vocab_size=ours.vocab_size, max_seq_len=ours.max_seq_len,
        ssm=dataclasses.replace(full.ssm, head_dim=ours.ssm.head_dim))


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def wkv_inputs(rng, B, S, H, hd, decay=None):
    """r, k, v (B, S, H, hd) * 0.5, w in (0.45, 0.95), u (H, hd) * 0.1,
    as f32 numpy arrays (the reference test's distributions)."""
    r, k, v = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(3))
    w = 0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((B, S, H, hd))))
    if decay is not None:
        w = np.full((B, S, H, hd), decay)
    u = 0.1 * rng.standard_normal((H, hd))
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


# ---------------------------------------------------------------------------
# Config and program words
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    ours = get_reduced(ARCH) if reduced else get_config(ARCH)
    theirs = jax_reduced() if reduced else jget_config(ARCH)
    for f in dataclasses.fields(ours):
        got, want = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name == "ssm":
            assert (got.kind, got.head_dim) == (want.kind, want.head_dim)
        elif f.name != "notes":
            assert got == want, f.name
    assert ours.param_count() == theirs.param_count()
    if not reduced:
        assert ours.param_count() == 1_476_886_528
        assert slot_bytes(ours, 528) == jslot_bytes(theirs, 528)


@pytest.mark.parametrize("fused", [False, True])
def test_program_words_match_reference(fused):
    prog = compile_program(get_config(ARCH),
                           ShapeConfig("serve", 528, 32, "decode"),
                           fused_decode=fused)
    jprog = jcompile(jget_config(ARCH), JShape("serve", 528, 32, "decode"),
                     MESH1, fused_decode=fused)
    assert sorted(prog.plan.ops) == sorted(jprog.plan.ops)
    for op in jprog.plan.ops:
        assert dataclasses.asdict(prog.pe_word(op)) \
            == dataclasses.asdict(jprog.pe_word(op)), op
    keys = ("op", "phase", "strategy", "dtype", "rounding", "kernel")
    assert prog.ibuffer_entries() == [{k: e[k] for k in keys}
                                      for e in jprog.ibuffer_entries()]


# ---------------------------------------------------------------------------
# wkv6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,hd,chunk", [(2, 128, 2, 16, 32),
                                            (2, 128, 2, 32, 64),
                                            (1, 64, 4, 64, 64)])
def test_wkv6_plain_matches_pallas_interpret(B, S, H, hd, chunk):
    r, k, v, w, u = wkv_inputs(np.random.default_rng(hd), B, S, H, hd)
    jy, js = jops.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                       chunk=chunk, interpret=True)
    y, s = kops.wkv6(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=WKV_TOL,
                               atol=WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=WKV_TOL,
                               atol=WKV_TOL)
    # the TPU kernel's (BH, S, hd) fold and the oracle's name agree
    fold = lambda a: torch.from_numpy(a).transpose(1, 2).reshape(
        B * H, S, hd).contiguous()
    uu = torch.from_numpy(np.tile(u, (B, 1)))
    yf, sf = kwkv.wkv6(fold(r), fold(k), fold(v), fold(w), uu)
    yr, sr = kref.wkv6_ref(fold(r), fold(k), fold(v), fold(w), uu)
    assert torch.equal(yf, yr) and torch.equal(sf, sr)
    assert torch.equal(yf.reshape(B, H, S, hd).transpose(1, 2), y)


@pytest.mark.parametrize("S", [1, 7, 32])
def test_wkv6_carried_state_matches_scan(S):
    B, H, hd = 3, 4, 32
    rng = np.random.default_rng(S)
    r, k, v, w, u = wkv_inputs(rng, B, S, H, hd)
    s0 = (0.3 * rng.standard_normal((B, H, hd, hd))).astype(np.float32)
    jy, js = jssm.wkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                            jnp.asarray(s0))
    state = torch.from_numpy(s0.copy())
    active = torch.tensor([True, False, True])
    y, s = kwkv.wkv6_bshd(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                          state, active=active)
    assert s is state                          # updated in place
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(s[active].numpy(), np.asarray(js)[[0, 2]],
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    assert np.array_equal(s[1].numpy(), s0[1])  # inactive row kept


def test_wkv6_chunks_equal_one_call():
    """State carried across calls: ragged chunks 5 + 1 + 10 == one call."""
    B, S, H, hd = 2, 16, 2, 16
    r, k, v, w, u = (torch.from_numpy(a) for a in
                     wkv_inputs(np.random.default_rng(7), B, S, H, hd))
    y_all, s_all = kwkv.wkv6_bshd(r, k, v, w, u)
    state = torch.zeros_like(s_all)
    ys = [kwkv.wkv6_bshd(*(t[:, a:b].contiguous() for t in (r, k, v, w)),
                         u, state)[0] for a, b in ((0, 5), (5, 6), (6, 16))]
    assert torch.equal(torch.cat(ys, dim=1), y_all)
    assert torch.equal(state, s_all)


def test_wkv6_strong_decay_stays_finite():
    B, S, H, hd = 1, 64, 1, 16
    r, k, v, w, u = wkv_inputs(np.random.default_rng(3), B, S, H, hd,
                               decay=1e-6)
    y, s = kops.wkv6(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    jy, _ = jssm.wkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


def test_wkv6_wrapper_refuses_other_devices():
    r = torch.zeros((1, 2, 1, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        kwkv.wkv6_bshd(r, r, r, r, torch.zeros((1, 16), device="meta"))


def test_wkv6_wrapper_refuses_f16_and_noncontiguous_inputs():
    """The kernel's operand checks run on every device: r, k, v bf16 or
    f32 (one type), w, u and the state f32, every operand contiguous."""
    B, S, H, hd = 2, 4, 2, 16
    r, k, v, w, u = (torch.from_numpy(a) for a in
                     wkv_inputs(np.random.default_rng(9), B, S, H, hd))
    state = torch.zeros((B, H, hd, hd))
    bf = [t.to(torch.bfloat16) for t in (r, k, v)]
    kwkv.wkv6_bshd(*bf, w, u, state)                  # bf16 r, k, v: taken
    for args in ([r.half(), k.half(), v.half(), w, u],
                 [bf[0], bf[1], v, w, u],             # mixed r, k, v
                 [r, k, v, w.to(torch.bfloat16), u],
                 [r, k, v, w, u.half()]):
        with pytest.raises(TypeError):
            kwkv.wkv6_bshd(*args, state)
    with pytest.raises(TypeError, match="f32"):
        kwkv.wkv6_bshd(r, k, v, w, u, state.double())
    strided = torch.zeros((B, 2 * S, H, hd))[:, ::2]
    for i in range(4):
        args = [r, k, v, w]
        args[i] = strided.copy_(args[i])
        with pytest.raises(TypeError, match="contiguous"):
            kwkv.wkv6_bshd(*args, u, state)
    with pytest.raises(TypeError, match="contiguous"):
        kwkv.wkv6_bshd(r, k, v, w, u, state.transpose(2, 3))
    with pytest.raises(TypeError, match="contiguous"):
        kwkv.wkv6(*(t[:, :, 0].transpose(0, 1) for t in (r, k, v, w)),
                  torch.zeros((S, hd)))


@pytest.mark.parametrize("B,S,H,hd", [(1, 32, 32, 64), (32, 1, 32, 64),
                                      (1, 100, 32, 64), (1, 257, 32, 64),
                                      (2, 37, 4, 64), (3, 9, 4, 32),
                                      (2, 5, 2, 16), (1, 1, 1, 16),
                                      (33, 1, 4, 32), (33, 12, 4, 64)])
def test_wkv6_plan_covers_every_column_once(B, S, H, hd):
    """wkv6_plan: block x owns columns (x % (hd/cols)) * cols + [0, cols)
    of head x // (hd/cols), a thread cv of them for each of the hd / 4
    row groups; every (b, h, column) once a row group, whole 32-byte
    sectors of the state rows, and the shared memory that csrc/wkv6.cu
    sizes from the plan within the card's 227 KB with bf16 or f32 r, k,
    v."""
    p = kwkv.wkv6_plan(B, H, S, hd)
    assert (p.cols, p.cv) in ((16, 1),) + ((hd, 4),) * (hd >= 32)
    assert hd % p.cols == 0 and p.cols * 4 % 32 == 0
    ncb, nq = hd // p.cols, p.cols // p.cv
    assert p.threads == hd // kwkv.ROWS * nq <= 1024
    # thread t of block x: rows 4 (t // nq) + [0, 4), columns
    # c0 + cv (t % nq) + [0, cv) of head x // ncb's state
    tid = np.arange(p.threads)
    rows = (kwkv.ROWS * (tid // nq))[:, None] + np.arange(kwkv.ROWS)
    cols = (p.cv * (tid % nq))[:, None] + np.arange(p.cv)
    owned = np.zeros((B * H, hd, hd), dtype=int)
    for x in range(p.grid):
        c0 = (x % ncb) * p.cols
        np.add.at(owned[x // ncb], (rows[:, :, None],
                                    c0 + cols[:, None, :]), 1)
    assert (owned == 1).all()
    assert 1 <= p.tile <= min(S, kwkv.TILE)
    assert p.stages == (2 if S > p.tile else 1)
    for es in (2, 4):                  # csrc/wkv6.cu::smem_need
        need = (p.stages * p.tile * (2 * hd * es + 4 * hd + p.cols * es)
                + p.tile * (hd // kwkv.ROWS) * p.cols * 4)
        assert need <= 232448          # sm_90's dynamic shared memory
    if (B, S, H, hd) == (1, 32, 32, 64):      # a one-slot PREFILL chunk
        assert (p.grid, p.cols, p.cv, p.threads) == (128, 16, 1, 256)
    if (B, S, H, hd) == (32, 1, 32, 64):      # a DECODE step of 32 slots
        assert (p.grid, p.cols, p.cv, p.threads) == (1024, 64, 4, 256)


def test_wkv6_plan_depends_on_the_shape_alone():
    """The plan takes (B, H, S, hd) and nothing else — not the dtype, the
    device or the data — and the same shape always gives the same plan."""
    import inspect
    assert list(inspect.signature(kwkv.wkv6_plan).parameters) == [
        "B", "H", "S", "hd"]
    shapes = [(1, 32, 32, 64), (32, 32, 1, 64), (1, 32, 257, 64),
              (2, 4, 37, 32)]
    assert [kwkv.wkv6_plan(*s) for s in shapes] == [
        kwkv.wkv6_plan(*s) for s in shapes]
    # the split changes with B * H and S, the tile with S
    assert kwkv.wkv6_plan(1, 4, 8, 64).cols == 16
    assert kwkv.wkv6_plan(1, 32, 1, 64).cols == 16
    assert kwkv.wkv6_plan(32, 32, 2, 64).cols == 16
    assert kwkv.wkv6_plan(32, 32, 1, 64).cols == 64
    assert kwkv.wkv6_plan(32, 32, 1, 16).cols == 16
    assert kwkv.wkv6_plan(1, 32, 100, 64).tile == kwkv.TILE


@pytest.mark.parametrize("S", [1, 6, 33])
def test_wkv6_plain_bf16_rkv_equals_their_f32_casts(S):
    """bf16 r, k, v give the same bits as their f32 casts (the cast is
    exact), from a carried state and on the `active` rows."""
    B, H, hd = 3, 2, 32
    rng = np.random.default_rng(10 + S)
    r, k, v, w, u = (torch.from_numpy(a) for a in
                     wkv_inputs(rng, B, S, H, hd))
    s0 = torch.from_numpy((0.3 * rng.standard_normal(
        (B, H, hd, hd))).astype(np.float32))
    bf = [t.to(torch.bfloat16) for t in (r, k, v)]
    y, s = kwkv.wkv6_plain(*bf, w, u, s0)
    y32, s32 = kwkv.wkv6_plain(*(t.float() for t in bf), w, u, s0)
    assert y.dtype == s.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(s, s32)
    active = torch.tensor([True, False, True])
    st, st32 = s0.clone(), s0.clone()
    yb, _ = kwkv.wkv6_bshd(*bf, w, u, st, active=active)
    yf, _ = kwkv.wkv6_bshd(*(t.float() for t in bf), w, u, st32,
                           active=active)
    assert torch.equal(yb, yf) and torch.equal(st, st32)
    assert torch.equal(st[1], s0[1])


# ---------------------------------------------------------------------------
# fused_ffn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm,act", [("layernorm", "relu_sq"),
                                      ("rmsnorm", "swiglu")])
def test_fused_ffn_plain_matches_pallas_interpret(norm, act):
    B, d, f = 3, 128, 256
    rng = np.random.default_rng(11)
    gated = act == "swiglu"
    x = rng.standard_normal((B, d)).astype(np.float32)
    w_in = (rng.standard_normal((d, 2 * f if gated else f))
            * d ** -0.5).astype(np.float32)
    w_out = (rng.standard_normal((f, d)) * f ** -0.5).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(d)).astype(np.float32)
    bias_or_none = bias if norm == "layernorm" else None
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = jdf.fused_ffn(jb(x), norm2_scale=jnp.asarray(scale),
                         norm2_bias=(None if bias_or_none is None
                                     else jnp.asarray(bias)),
                         w_in=jb(w_in), w_out=jb(w_out), norm_kind=norm,
                         act=act, block_n=64, interpret=True)
    tb = lambda a: torch.from_numpy(a).bfloat16()
    got = kops.fused_ffn(tb(x), norm2_scale=torch.from_numpy(scale),
                         norm2_bias=(None if bias_or_none is None
                                     else torch.from_numpy(bias)),
                         w_in=tb(w_in), w_out=tb(w_out), norm_kind=norm,
                         act=act, block_n=64)
    assert got.dtype == torch.bfloat16 and got.shape == (B, d)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# rwkv_block with a carried state
# ---------------------------------------------------------------------------


# rwkv_block in f32 holds the algorithm (f32 sums in another order; the
# reference backend: the cuda backend's PREFILL word runs its products at
# the word's bf16 FF dtype); in bf16 the reference's CPU silu (a bf16 logistic times x) differs from
# the correctly rounded silu by a bf16 step on ~40% of elements, and the
# o-projection sums d such terms of the block's largest magnitude: held
# within 2e-2 of that magnitude.
BLOCK_F32_TOL, BLOCK_BF16_REL = 1e-4, 2e-2


@pytest.mark.parametrize("dtype,backends", [
    ("float32", ("reference",)), ("bfloat16", ("reference", "cuda"))])
def test_rwkv_block_with_state_matches_reference(dtype, backends):
    cfg, jcfg = get_reduced(ARCH), jax_reduced()
    B, S, d = 2, 5, cfg.d_model
    H, hd = d // cfg.ssm.head_dim, cfg.ssm.head_dim
    rng = np.random.default_rng(5)
    p = {k: np.array(v) for k, v in jssm.rwkv_params(
        jcfg, jax.random.PRNGKey(2)).items()}
    p["w0"] = (-2 + 0.5 * rng.standard_normal(d)).astype(np.float32)
    p["mix"] = rng.uniform(0, 1, (5, d)).astype(np.float32)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    wkv0 = (0.3 * rng.standard_normal((B, H, hd, hd))).astype(np.float32)
    shift0 = rng.standard_normal((B, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jst = jssm.rwkv_block(
        jcfg, jnp.asarray(x).astype(jdt),
        jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p), Sharder(),
        {"wkv": jnp.asarray(wkv0), "shift": jnp.asarray(shift0).astype(jdt)})
    tp = params_from_numpy(p, "cpu", tdt)
    want = to_np(jout)
    atol = (BLOCK_F32_TOL if dtype == "float32"
            else BLOCK_BF16_REL * np.abs(want).max())
    for backend in backends:
        st = {"wkv": torch.from_numpy(wkv0.copy()),
              "shift": torch.from_numpy(shift0.copy()).to(tdt)}
        out = ssm.rwkv_block(cfg, torch.from_numpy(x).to(tdt), tp,
                             PEContext(backend=backend), st)
        assert out.dtype == tdt
        np.testing.assert_allclose(to_np(out), want, atol=atol,
                                   rtol=BLOCK_F32_TOL if dtype == "float32"
                                   else LOGIT_TOL)
        np.testing.assert_allclose(
            to_np(st["wkv"]), to_np(jst["wkv"]),
            atol=BLOCK_F32_TOL if dtype == "float32" else STATE_TOL,
            rtol=BLOCK_F32_TOL if dtype == "float32" else STATE_TOL)
        assert np.array_equal(to_np(st["shift"]), to_np(jst["shift"]))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_rwkv_block_passes_rkv_uncopied_with_the_same_bits(monkeypatch,
                                                           backend):
    """rwkv_block hands the recurrence the projections' bf16 r, k, v as
    they are (no f32 copy) and gives the same bits as with the f32 copies
    it made before, on the reference backend and on the cuda backend's
    CPU plain path, from a carried state on the `active` rows."""
    cfg = get_reduced(ARCH)
    B, S, d = 3, 6, cfg.d_model
    H, hd = d // cfg.ssm.head_dim, cfg.ssm.head_dim
    rng = np.random.default_rng(11)
    gen = torch.Generator().manual_seed(3)
    p = {k: v.to(torch.bfloat16) for k, v in
         ssm.rwkv_params(cfg, gen).items()}
    p["w0"] = torch.from_numpy(
        (-2 + 0.5 * rng.standard_normal(d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B, S, d)).astype(
        np.float32)).to(torch.bfloat16)
    wkv0 = torch.from_numpy((0.3 * rng.standard_normal(
        (B, H, hd, hd))).astype(np.float32))
    shift0 = torch.from_numpy(rng.standard_normal((B, d)).astype(
        np.float32)).to(torch.bfloat16)
    active = torch.tensor([True, False, True])
    name = "wkv6_bshd" if backend == "cuda" else "wkv6_bshd_plain"
    orig = getattr(kwkv, name)
    seen = []

    def spy(r, k, v, w, *rest, **kw):
        seen.append((r.dtype, k.dtype, v.dtype, w.dtype))
        return orig(r, k, v, w, *rest, **kw)

    def copying(r, k, v, w, *rest, **kw):     # the f32 copies of before
        return orig(*(t.to(torch.float32).contiguous()
                      for t in (r, k, v, w)), *rest, **kw)

    outs = []
    for fn in (spy, copying):
        monkeypatch.setattr(kwkv, name, fn)
        st = {"wkv": wkv0.clone(), "shift": shift0.clone()}
        with torch.no_grad():
            out = ssm.rwkv_block(cfg, x, p, PEContext(backend=backend), st,
                                 active=active)
        outs.append((out, st))
    assert seen == [(torch.bfloat16,) * 3 + (torch.float32,)]
    (out, st), (out_c, st_c) = outs
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, out_c)
    assert torch.equal(st["wkv"], st_c["wkv"])
    assert torch.equal(st["wkv"][1], wkv0[1])
    assert not torch.equal(st["wkv"][0], wkv0[0])


# ---------------------------------------------------------------------------
# The slice, teacher-forced, against the reference
# ---------------------------------------------------------------------------

B, MAX_LEN, T = 2, 24, 4


@pytest.fixture(scope="module")
def slice_run():
    """The reference's params (random norm scales and biases), and its
    logits and state over 2 chunks of T tokens then 3 decode steps: per
    op (its fused decode on its reference backend is bit-identical to
    that, tests/test_decode_fused.py), and fused on its pallas backend
    (interpret mode), whose fused_ffn has the cast order of the port's
    cuda backend."""
    cfg = jax_reduced()
    params = jax.tree.map(np.array, jtfm.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    u = params["groups"]["u0"]
    for norm in (u["norm1"], u["norm2"], params["final_norm"]):
        norm["scale"][...] = 1.0 + 0.3 * rng.standard_normal(
            norm["scale"].shape)
        norm["bias"][...] = 0.3 * rng.standard_normal(norm["bias"].shape)
    toks = rng.integers(0, cfg.vocab_size, size=(B, 2 * T + 3)).astype(np.int32)
    jparams = jtl.cast_params(jax.tree.map(jnp.asarray, params), jnp.bfloat16)
    shape = JShape("serve", MAX_LEN, B, "decode")
    prog = jcompile(cfg, shape, MESH1)
    chunk = jax.jit(jtl.make_chunk_step(cfg, prog, None))
    cache = jtfm.init_cache(cfg, B, MAX_LEN)
    prefill = []
    for c in range(2):
        lg, cache = chunk(jparams, cache, jnp.asarray(toks[:, c * T:(c + 1) * T]),
                          jnp.full((B,), c * T, jnp.int32))
        prefill.append(np.asarray(lg))
    out = {}
    for fused in (False, True):
        step = jax.jit(
            jtl.make_fused_decode_step(
                cfg, jcompile(cfg, shape, MESH1, fused_decode=True), None,
                kernel_backend="pallas") if fused
            else jtl.make_decode_step(cfg, prog, None))
        c, logits = cache, list(prefill)
        for t in range(3):
            p = 2 * T + t
            lg, c = step(jparams, c, jnp.asarray(toks[:, p:p + 1]),
                         jnp.full((B,), p, jnp.int32))
            logits.append(np.asarray(lg))
        out[fused] = (logits, {k: to_np(v) for k, v in leaves(c).items()})
    return params, toks, out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_slice_matches_reference_teacher_forced(slice_run, backend, fused):
    params, toks, ref = slice_run
    cfg = get_reduced(ARCH)
    tparams = params_from_numpy(params, "cpu", torch.bfloat16)
    prog = compile_program(cfg, ShapeConfig("serve", MAX_LEN, B, "decode"),
                           fused_decode=fused)
    chunk = tl.make_chunk_step(cfg, prog, kernel_backend=backend)
    step = (tl.make_fused_decode_step if fused
            else tl.make_decode_step)(cfg, prog, kernel_backend=backend)
    cache = tfm.init_cache(cfg, B, MAX_LEN)
    logits = []
    with torch.no_grad():
        for c in range(2):
            lg, cache = chunk(tparams, cache,
                              torch.from_numpy(toks[:, c * T:(c + 1) * T]),
                              torch.full((B,), c * T, dtype=torch.int32))
            logits.append(lg.numpy())
        for t in range(3):
            p = 2 * T + t
            lg, cache = step(tparams, cache, torch.from_numpy(toks[:, p:p + 1]),
                             torch.full((B,), p, dtype=torch.int32))
            logits.append(lg.numpy())
    # the cuda backend's fused word has the reference's fused cast order
    want_logits, want_cache = ref[fused and backend == "cuda"]
    for got, want in zip(logits, want_logits):
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    got_cache = leaves(cache)
    assert sorted(got_cache) == sorted(want_cache)
    for k, want in want_cache.items():
        np.testing.assert_allclose(to_np(got_cache[k]), want,
                                   atol=STATE_TOL, rtol=STATE_TOL)


def test_params_from_numpy_carries_rwkv_leaves():
    jp = jtl.cast_params(jtfm.init(jax.random.PRNGKey(1), jax_reduced()),
                         jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ours = tfm.init(torch.Generator().manual_seed(0), get_reduced(ARCH))
    assert {k: tuple(v.shape) for k, v in leaves(tp).items()} \
        == {k: tuple(v.shape) for k, v in leaves(ours).items()}
    assert sorted(leaves(tp["groups"]["u0"]["rwkv"])) == sorted(
        ["rkvg", "decay", "o", "w0", "u", "mix"])
    for name in ("rkvg", "u", "mix"):
        a = jp["groups"]["u0"]["rwkv"][name]
        assert np.array_equal(
            np.asarray(jax.lax.bitcast_convert_type(a, jnp.uint16)),
            tp["groups"]["u0"]["rwkv"][name].view(torch.int16).numpy()
            .view(np.uint16))


# ---------------------------------------------------------------------------
# The engine (the port's reference backend, CPU)
# ---------------------------------------------------------------------------


def mixed_requests(cfg, lens, gen, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=f"r{i}", prompt=tuple(int(x) for x in rng.integers(
        0, cfg.vocab_size, size=n)), max_new_tokens=gen, arrival_step=i)
        for i, n in enumerate(lens)]


def run(cfg, reqs, **kw):
    kw = {"n_slots": 3, "max_len": 32, "prefill_chunk": 6, "seed": 0,
          "device": "cpu", **kw}
    eng = build_engine(cfg, **kw)
    with torch.no_grad():
        return eng.run(reqs), eng


@pytest.fixture(scope="module")
def engine_reference_run():
    cfg = get_reduced(ARCH)
    reqs = mixed_requests(cfg, [13, 4, 20, 7], gen=6, seed=1)
    res, eng = run(cfg, reqs)
    return cfg, reqs, res, eng


def test_fused_decode_bit_identical_on_reference(engine_reference_run):
    cfg, reqs, res, _ = engine_reference_run
    fused, eng = run(cfg, reqs, fused_decode=True)
    assert eng.program.fused_decode and fused == res


def test_chunked_prefill_equals_token_by_token(engine_reference_run):
    cfg, reqs, res, eng = engine_reference_run
    assert eng.step_count > 0
    tok_by_tok, _ = run(cfg, reqs, prefill_chunk=64)
    assert res == tok_by_tok


def test_chunk_then_decode_equals_one_long_decode():
    """Logits and state, bit for bit: two chunks then decode steps carry
    the state exactly as decoding every token does."""
    cfg = get_reduced(ARCH)
    prog = compile_program(cfg, ShapeConfig("serve", 16, 2, "decode"))
    gen = torch.Generator().manual_seed(3)
    params = tl.cast_params(tfm.init(gen, cfg), torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(2, 11)).astype(np.int32))
    chunk = tl.make_chunk_step(cfg, prog)
    step = tl.make_decode_step(cfg, prog)
    c1, c2 = tfm.init_cache(cfg, 2, 16), tfm.init_cache(cfg, 2, 16)
    with torch.no_grad():
        a = [chunk(params, c1, toks[:, :5], torch.zeros(2, dtype=torch.int32))[0],
             chunk(params, c1, toks[:, 5:8],
                   torch.full((2,), 5, dtype=torch.int32))[0]]
        a += [step(params, c1, toks[:, p:p + 1],
                   torch.full((2,), p, dtype=torch.int32))[0]
              for p in range(8, 11)]
        b = [step(params, c2, toks[:, p:p + 1],
                  torch.full((2,), p, dtype=torch.int32))[0]
             for p in range(11)]
    assert torch.equal(torch.cat(a, dim=1), torch.cat(b, dim=1))
    for k, v in leaves(c1).items():
        assert torch.equal(v, leaves(c2)[k]), k


def test_reset_slots_zeroes_a_released_rwkv_row():
    cfg = get_reduced(ARCH)
    cache = tfm.init_cache(cfg, 3, 16)
    g = torch.Generator().manual_seed(1)
    for leaf in leaves(cache).values():
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    before = {k: v.clone() for k, v in leaves(cache).items()}
    reset_slots(cache, [1])
    for k, v in leaves(cache).items():
        assert not v[:, 1].any(), k
        assert torch.equal(v[:, [0, 2]], before[k][:, [0, 2]]), k


def test_released_slot_serves_like_a_fresh_one(engine_reference_run):
    """One slot leased four times in turn: each request's tokens equal
    its tokens in the 3-slot run, so no state leaks across leases."""
    cfg, reqs, res, _ = engine_reference_run
    one, eng = run(cfg, reqs, n_slots=1)
    assert one == res and eng.n_slots == 1


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_masked_decode_leaves_inactive_rows_unchanged(backend, fused):
    cfg = get_reduced(ARCH)
    eng = build_engine(cfg, n_slots=3, max_len=16, device="cpu",
                       kernel_backend=backend, fused_decode=fused)
    g = torch.Generator().manual_seed(5)
    for leaf in leaves(eng.cache).values():
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    before = {k: v.clone() for k, v in leaves(eng.cache).items()}
    eng._decode(np.array([[3], [4], [5]], np.int32),
                np.array([5, 6, 7], np.int32), np.array([True, False, True]))
    for k, v in leaves(eng.cache).items():
        assert torch.equal(v[:, 1], before[k][:, 1]), k
        assert not torch.equal(v[:, 0], before[k][:, 0]), k


# Generated tokens against the JAX engine.  Both run the same bf16
# weights; products accumulate in f32 (reference) and f64 (port), so a
# logit may move by a bf16 step and flip a near-tie argmax, after which
# that request's continuation differs.  Held: every request's first
# token, and at least 90% of all tokens.
TOKEN_AGREEMENT = 0.9


def test_engine_tokens_match_jax_engine():
    jcfg = jax_reduced()
    reqs = mixed_requests(jcfg, [13, 4, 20, 7], gen=6, seed=2)
    jeng = jbuild_engine(jcfg, n_slots=3, max_len=32, prefill_chunk=6,
                         seed=0)
    jres = jeng.run([dataclasses.replace(r) for r in reqs])
    tparams = params_from_numpy(jax.tree.map(np.asarray, jeng.params), "cpu")
    for backend, fused in (("reference", False), ("cuda", True)):
        res, _ = run(get_reduced(ARCH), reqs, params=tparams,
                     kernel_backend=backend, fused_decode=fused)
        assert all(res[r.rid][0] == jres[r.rid][0] for r in reqs)
        same = sum(a == b for r in reqs
                   for a, b in zip(res[r.rid], jres[r.rid]))
        assert same >= TOKEN_AGREEMENT * sum(len(jres[r.rid]) for r in reqs)


def test_serve_cli_rwkv6_on_cpu(capsys):
    kmm.COUNTER.reset()
    kwkv.COUNTER.reset()
    kdf.FFN_COUNTER.reset()
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "2", "--prompt-lens", "4,12", "--gen",
                       "3", "--slots", "2", "--chunk", "4",
                       "--kernel-backend", "cuda", "--fused-decode"]) == 0
    out = capsys.readouterr().out
    assert "arch=rwkv6-1.6b" in out and "sample (req-0000)" in out
    # CPU tensors: every kernel wrapper ran its plain version
    assert kmm.COUNTER.n == kwkv.COUNTER.n == kdf.FFN_COUNTER.n == 0
