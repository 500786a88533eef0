"""The port's MoE serving slice and the two dense configs that ride with
it (granite-moe-1b-a400m, olmo-1b, minitron-4b) against the JAX package.

Inputs are made with numpy from a seed and go through both packages;
the reference's parameters reach the port through ``params_from_numpy``.

- configs and program words equal the reference's;
- routing and dispatch: ``_capacity`` and ``_dispatch_indices`` equal
  JAX's exactly; ``_route``'s combine weights and aux within 1e-6, its
  top-k experts equal on every token whose sorted probabilities, down to
  the (k+1)-th, are more than 1e-5 apart (a nearer pair may order
  differently: the port's router logits are f64 sums rounded to f32,
  JAX's f32 sums), and such tokens at most 2% of the tokens;
- ``moe_block`` against JAX's ``_moe_single`` on the reference backend
  in f32 (the algorithm, not bf16 rounding), rtol 1e-5 (atol 1e-6 for
  outputs near zero: f32 sums in another order) on the tokens the
  routing check keeps;
- the batched ``sr_matmul``'s plain version against ``jax.vmap`` of the
  reference's ``sr_matmul`` in interpret mode, at the kernel tests'
  f32-path tolerance;
- serving, per arch (reduced): chunk and decode steps teacher-forced
  against JAX's (tests/test_torch_serving.py's tolerances), and on the
  reference backend chunked prefill == token-by-token decode and fused
  == per-op decode, bit for bit;
- training a MoE config raises NotImplementedError.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core.dataflow import MeshSpec  # noqa: E402
from repro.core.program import compile_program as jcompile  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.layers import Sharder  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402
from repro_torch.engine.context import PEContext  # noqa: E402
from repro_torch.kernels import sr_matmul as kmm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import train_loop as tl  # noqa: E402
from repro_torch.serving import Request, build_engine  # noqa: E402

MESH1 = MeshSpec(axis_sizes={"data": 1, "model": 1}, batch_axes=("data",))
GRANITE = "granite-moe-1b-a400m"
ARCHS = (GRANITE, "olmo-1b", "minitron-4b")
# teacher-forced serving (tests/test_torch_serving.py, from
# tests/test_decode_fused.py): bf16 logits and caches
LOGIT_TOL, CACHE_TOL = 2e-2, 6e-2
# the f32-path tolerance of the kernel tests (tests/test_kernels.py)
MM_RTOL, MM_ATOL = 5e-4, 1e-4
TIE_GAP = 1e-5            # sorted probabilities nearer than this may swap
MAX_TIE_SHARE = 0.02


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# Configs and program words
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, reduced):
    ours = get_reduced(arch) if reduced else get_config(arch)
    theirs = jget_reduced(arch) if reduced else jget_config(arch)
    for f in dataclasses.fields(ours):
        want, got = getattr(theirs, f.name), getattr(ours, f.name)
        if f.name in ("attention", "moe") and want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()
    assert [ours.is_moe_layer(i) for i in range(ours.n_layers)] \
        == [theirs.is_moe_layer(i) for i in range(theirs.n_layers)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_program_words_match_reference(arch, reduced, fused):
    cfg = get_reduced(arch) if reduced else get_config(arch)
    jcfg = jget_reduced(arch) if reduced else jget_config(arch)
    prog = compile_program(cfg, ShapeConfig("serve", 528, 32, "decode"),
                           fused_decode=fused)
    jprog = jcompile(jcfg, JShape("serve", 528, 32, "decode"), MESH1,
                     fused_decode=fused)
    assert sorted(prog.plan.ops) == sorted(jprog.plan.ops)
    for op in jprog.plan.ops:
        assert dataclasses.asdict(prog.pe_word(op)) \
            == dataclasses.asdict(jprog.pe_word(op)), op
    keys = ("op", "phase", "strategy", "dtype", "rounding", "kernel")
    assert prog.ibuffer_entries() == [{k: e[k] for k in keys}
                                      for e in jprog.ibuffer_entries()]


# ---------------------------------------------------------------------------
# Routing and dispatch
# ---------------------------------------------------------------------------


@given(t=st.integers(min_value=1, max_value=6000),
       e=st.sampled_from([2, 4, 8, 32]),
       k=st.integers(min_value=1, max_value=8))
@settings(max_examples=60, deadline=None, derandomize=True)
def test_capacity_matches_reference(t, e, k):
    assert moe._capacity(t, k, e) == jmoe._capacity(t, k, e)


# T from a few values, so JAX's eager ops meet repeated shapes
@given(t=st.sampled_from([1, 5, 8, 32, 40, 257]),
       e=st.sampled_from([2, 4, 8, 32]),
       k=st.integers(min_value=1, max_value=8),
       dropless=st.booleans(),
       seed=st.integers(min_value=0, max_value=10_000))
@settings(max_examples=40, deadline=None, derandomize=True)
def test_dispatch_indices_match_reference(t, e, k, dropless, seed):
    k = min(k, e)
    experts = np.random.default_rng(seed).integers(0, e, size=t * k)
    C = max(8, -(-t // 8) * 8) if dropless else moe._capacity(t, k, e)
    slot, keep = moe._dispatch_indices(torch.from_numpy(experts), e, C)
    jslot, jkeep = jmoe._dispatch_indices(jnp.asarray(experts, jnp.int32),
                                          e, C)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


def _kept_tokens(probs: np.ndarray, k: int) -> np.ndarray:
    """Tokens whose k + 1 largest probabilities are all more than TIE_GAP
    apart: their top k (set and order) cannot swap between packages."""
    top = -np.sort(-probs, axis=-1)[:, :k + 1]
    return np.all(top[:, :-1] - top[:, 1:] > TIE_GAP, axis=-1)


def _route_case(d, E, T, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("reduced", [False, True])
def test_route_matches_reference(reduced):
    """At granite's full router (d 1024, 32 experts, top-8) and its
    reduced one (d 64, 4 experts, top-2), 512 tokens."""
    cfg = get_reduced(GRANITE) if reduced else get_config(GRANITE)
    m = cfg.moe
    x, w = _route_case(cfg.d_model, m.n_experts, 512, seed=3)
    topv, topi, aux = moe._route(torch.from_numpy(x), torch.from_numpy(w),
                                 m.top_k, PEContext())
    jv, ji, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(w), m.top_k)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), -1))
    kept = _kept_tokens(probs, m.top_k)
    n_tied = int((~kept).sum())
    print(f"_route: {n_tied} of {len(kept)} tokens within {TIE_GAP} of a "
          f"swap, left out")
    assert n_tied <= MAX_TIE_SHARE * len(kept)
    np.testing.assert_array_equal(topi.numpy()[kept], np.asarray(ji)[kept])
    np.testing.assert_allclose(topv.numpy()[kept], np.asarray(jv)[kept],
                               rtol=0, atol=1e-6)
    assert topv.dtype == torch.float32 and topi.dtype == torch.int64
    if kept.all():
        assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("T", [1, 8, 32, 40])
def test_moe_block_matches_reference(T):
    cfg = get_reduced(GRANITE)
    jp = jax.tree.map(np.asarray, jmoe.moe_params(cfg, jax.random.PRNGKey(T)))
    x = np.random.default_rng(T).standard_normal(
        (1, T, cfg.d_model)).astype(np.float32)
    want, jaux = jmoe.moe_block(cfg, jnp.asarray(x),
                                jax.tree.map(jnp.asarray, jp), Sharder())
    got, aux = moe.moe_block(cfg, torch.from_numpy(x), params_from_numpy(jp),
                             PEContext())
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x[0]) @ jp["router"], -1))
    kept = _kept_tokens(probs, cfg.moe.top_k)
    assert kept.sum() >= (1 - MAX_TIE_SHARE) * T
    np.testing.assert_allclose(got.numpy()[0][kept], np.asarray(want)[0][kept],
                               rtol=1e-5, atol=1e-6)
    if kept.all():
        assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("emnk", [(4, 8, 96, 64), (3, 37, 64, 200),
                                  (2, 5, 130, 72)])
def test_sr_matmul_batched_plain_matches_vmapped_pallas(emnk, trans_b):
    e, m, n, k = emnk
    rng = np.random.default_rng(5)
    a = rng.standard_normal((e, m, k)).astype(np.float32)
    b = rng.standard_normal((e, n, k) if trans_b else (e, k, n)
                            ).astype(np.float32)
    aj, bj = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = jax.vmap(lambda x, y: jops.sr_matmul(
        x, y, None, sr=False, block=(64, 64, 64), interpret=True,
        trans_b=trans_b))(aj, bj)
    at = torch.from_numpy(a).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    assert torch.equal(at.float(), torch.from_numpy(to_np(aj).copy()))
    got = kmm.sr_matmul_batched(at, bt, trans_b=trans_b)
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_RTOL,
                               atol=MM_ATOL)
    assert torch.equal(got, kmm.sr_matmul_batched_plain(at, bt,
                                                        trans_b=trans_b))


@pytest.mark.parametrize("kn", [(1024, 512), (512, 1024)], ids=str)
def test_batched_plan_at_granite_shapes(kn):
    """The batched mode plans one expert's product over all 32 experts'
    tiles: 128-wide column tiles and no split at granite's tables, for
    every C (a row's sums never depend on C); the same product alone
    takes the 2-D rule (64-wide tiles)."""
    k, n = kn
    plans = {kmm.plan(m, n, k, "k", "n", experts=32)
             for m in (1, 8, 32, 40, 130)}
    assert plans == {kmm.Plan("sm90", 128, 128, 64, 1)}
    assert kmm.plan(32, n, k, "k", "n").bn == 64


def test_params_from_numpy_carries_the_moe_leaves():
    cfg = jget_reduced(GRANITE)
    jp = jtl.cast_params(jtfm.init(jax.random.PRNGKey(1), cfg), jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ours = tfm.init(torch.Generator().manual_seed(0), get_reduced(GRANITE))
    assert {k: tuple(v.shape) for k, v in leaves(tp).items()} \
        == {k: tuple(v.shape) for k, v in leaves(ours).items()}
    assert sorted(ours["groups"]["u0"]["moe"]) == [
        "experts_gate", "experts_in", "experts_out", "router"]
    assert "ffn" not in ours["groups"]["u0"]
    a = jp["groups"]["u0"]["moe"]["experts_gate"]
    assert np.array_equal(
        np.asarray(jax.lax.bitcast_convert_type(a, jnp.uint16)),
        tp["groups"]["u0"]["moe"]["experts_gate"].view(torch.int16).numpy()
        .view(np.uint16))


# ---------------------------------------------------------------------------
# Serving, teacher-forced against the reference
# ---------------------------------------------------------------------------

B, MAX_LEN, T = 2, 24, 4


def _reference_params(arch: str):
    """The reference's params with random norm scales and biases."""
    cfg = jget_reduced(arch)
    params = jax.tree.map(np.array, jtfm.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    for path, leaf in leaves(params).items():
        if "norm" in path:
            base = 1.0 if path.endswith("scale") else 0.0
            leaf[...] = base + 0.3 * rng.standard_normal(leaf.shape)
    return cfg, params, rng


@pytest.fixture(scope="module", params=ARCHS)
def slice_run(request):
    """Two chunks of T tokens, then 3 decode steps, per-op and fused, on
    the reference's bf16 params: its logits and caches."""
    arch = request.param
    cfg, params, rng = _reference_params(arch)
    toks = rng.integers(0, cfg.vocab_size, size=(B, 2 * T + 3)).astype(np.int32)
    jparams = jtl.cast_params(jax.tree.map(jnp.asarray, params), jnp.bfloat16)
    shape = JShape("serve", MAX_LEN, B, "decode")
    out = {}
    for fused in (False, True):
        prog = jcompile(cfg, shape, MESH1, fused_decode=fused)
        chunk = jax.jit(jtl.make_chunk_step(cfg, prog, None))
        step = jax.jit((jtl.make_fused_decode_step if fused
                        else jtl.make_decode_step)(cfg, prog, None))
        cache = jtfm.init_cache(cfg, B, MAX_LEN)
        logits = []
        for c in range(2):
            lg, cache = chunk(jparams, cache,
                              jnp.asarray(toks[:, c * T:(c + 1) * T]),
                              jnp.full((B,), c * T, jnp.int32))
            logits.append(np.asarray(lg))
        for t in range(3):
            p = 2 * T + t
            lg, cache = step(jparams, cache, jnp.asarray(toks[:, p:p + 1]),
                             jnp.full((B,), p, jnp.int32))
            logits.append(np.asarray(lg))
        out[fused] = (logits, {k: to_np(v) for k, v in leaves(cache).items()})
    return arch, params, toks, out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_slice_matches_reference_teacher_forced(slice_run, backend, fused):
    arch, params, toks, ref = slice_run
    cfg = get_reduced(arch)
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
            lg, cache = step(tparams, cache,
                             torch.from_numpy(toks[:, p:p + 1]),
                             torch.full((B,), p, dtype=torch.int32))
            logits.append(lg.numpy())
    want_logits, want_cache = ref[fused]
    for got, want in zip(logits, want_logits):
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    got_cache = leaves(cache)
    assert sorted(got_cache) == sorted(want_cache)
    for k, want in want_cache.items():
        if k.endswith("pos"):
            np.testing.assert_array_equal(to_np(got_cache[k]), want)
        else:
            np.testing.assert_allclose(to_np(got_cache[k]), want,
                                       atol=CACHE_TOL, rtol=CACHE_TOL)


# ---------------------------------------------------------------------------
# Engine invariants on the reference backend (CPU)
# ---------------------------------------------------------------------------


def _requests(cfg, lens, gen, seed):
    rng = np.random.default_rng(seed)
    return [Request(rid=f"r{i}", prompt=tuple(int(x) for x in rng.integers(
        0, cfg.vocab_size, size=n)), max_new_tokens=gen, arrival_step=i)
        for i, n in enumerate(lens)]


def _serve(cfg, reqs, **kw):
    kw = {"n_slots": 3, "max_len": 32, "prefill_chunk": 6, "seed": 0,
          "device": "cpu", **kw}
    eng = build_engine(cfg, **kw)
    with torch.no_grad():
        return eng.run(reqs)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_invariants_on_reference(arch):
    """Chunked prefill == token by token (a chunk wider than every
    prompt), and fused == per-op decode, bit for bit."""
    cfg = get_reduced(arch)
    reqs = _requests(cfg, [13, 4, 20, 7], gen=5, seed=1)
    res = _serve(cfg, reqs)
    assert sum(len(v) for v in res.values()) == 4 * 5
    assert _serve(cfg, reqs, prefill_chunk=64) == res
    assert _serve(cfg, reqs, fused_decode=True) == res


# ---------------------------------------------------------------------------
# Training: not ported for MoE
# ---------------------------------------------------------------------------


def test_training_a_moe_config_raises():
    cfg = get_reduced(GRANITE)
    prog = compile_program(cfg, ShapeConfig("t", 16, 2, "train"))
    step, _ = tl.make_train_step(cfg, prog, TrainConfig())
    state = tl.init_state(cfg, prog, TrainConfig(),
                          torch.Generator().manual_seed(0))
    toks = np.zeros((2, 16), np.int32)
    with pytest.raises(NotImplementedError, match="MoE"):
        step(state, {"tokens": toks, "labels": toks}, 0)
    with pytest.raises(NotImplementedError, match="MoE"):
        tfm.loss_fn(cfg, state["params"], {"tokens": torch.from_numpy(toks),
                                            "labels": torch.from_numpy(toks)},
                    PEContext(prog))
