"""The port's serving slice against the JAX package, and its own invariants.

- program words, configs and traces equal the reference's;
- the slice: with the reference's own ``tfm.init`` parameters carried
  across (``params_from_numpy``), qwen2-0.5b --reduced runs two prompt
  chunks and three decode steps (per-op and fused) teacher-forced on both
  sides; logits agree within 2e-2 and caches within 6e-2
  (tests/test_decode_fused.py's tolerances), on the port's reference
  backend and on its cuda backend (whose kernels run their plain
  versions on CPU tensors);
- the engine's invariants on the port's reference backend: chunked
  prefill == token-by-token decode, engine == each request served alone
  (also under eviction, for qwen2 and granite, and with a windowed ring
  that wraps inside a chunk), masked decode leaves inactive arena rows
  untouched;
- entry points run on CUDA unless asked for the CPU, and never fall back.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core.dataflow import MeshSpec  # noqa: E402
from repro.core.program import compile_program as jcompile  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro.serving import poisson_trace as jpoisson  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402
from repro_torch.kernels import decode_fused as kdf  # noqa: E402
from repro_torch.kernels import sr_matmul as kmm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import train_loop as tl  # noqa: E402
from repro_torch.serving import (Request, ServingEngine,  # noqa: E402
                                 build_engine, poisson_trace)

MESH1 = MeshSpec(axis_sizes={"data": 1, "model": 1}, batch_axes=("data",))
ARCH = "qwen2-0.5b"
LOGIT_TOL, CACHE_TOL = 2e-2, 6e-2


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def leaves(tree, prefix=""):
    """{path: leaf} of a nested dict (both packages' caches)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# Configs, program words, traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    ours = get_reduced(ARCH) if reduced else get_config(ARCH)
    theirs = jget_reduced(ARCH) if reduced else jget_config(ARCH)
    for f in dataclasses.fields(ours):
        want = getattr(theirs, f.name)
        got = getattr(ours, f.name)
        if f.name == "attention":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    assert ours.param_count() == theirs.param_count()
    if not reduced:
        assert ours.param_count() == 494_031_872


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("reduced", [False, True])
def test_program_words_match_reference(reduced, fused):
    cfg = get_reduced(ARCH) if reduced else get_config(ARCH)
    jcfg = jget_reduced(ARCH) if reduced else jget_config(ARCH)
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


def test_poisson_trace_matches_reference():
    kw = dict(vocab_size=151936, prompt_lens=(16, 512), gen_tokens=16,
              mean_interarrival_steps=2.0, seed=3)
    ours, theirs = poisson_trace(16, **kw), jpoisson(16, **kw)
    assert [(r.rid, r.prompt, r.max_new_tokens, r.arrival_step)
            for r in ours] == [(r.rid, r.prompt, r.max_new_tokens,
                                r.arrival_step) for r in theirs]


# ---------------------------------------------------------------------------
# The slice, teacher-forced, against the reference
# ---------------------------------------------------------------------------

B, MAX_LEN, T = 2, 24, 4


@pytest.fixture(scope="module")
def slice_run():
    """The reference's params (random nonzero norm scales and qkv bias)
    and its logits/caches: 2 chunks of T tokens, then 3 decode steps."""
    cfg = jget_reduced(ARCH)
    params = jax.tree.map(np.array, jtfm.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    u = params["groups"]["u0"]
    for leaf in (u["norm1"]["scale"], u["norm2"]["scale"],
                 params["final_norm"]["scale"]):
        leaf[...] = 1.0 + 0.3 * rng.standard_normal(leaf.shape)
    u["attn"]["qkv_bias"][...] = 0.3 * rng.standard_normal(
        u["attn"]["qkv_bias"].shape)
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
            lg, cache = chunk(jparams, cache, jnp.asarray(toks[:, c * T:(c + 1) * T]),
                              jnp.full((B,), c * T, jnp.int32))
            logits.append(np.asarray(lg))
        for t in range(3):
            p = 2 * T + t
            lg, cache = step(jparams, cache, jnp.asarray(toks[:, p:p + 1]),
                             jnp.full((B,), p, jnp.int32))
            logits.append(np.asarray(lg))
        out[fused] = (logits, {k: to_np(v) for k, v in leaves(cache).items()})
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


def test_params_from_numpy_keeps_layout_and_bits():
    cfg = jget_reduced(ARCH)
    jp = jtl.cast_params(jtfm.init(jax.random.PRNGKey(1), cfg), jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ours = tfm.init(torch.Generator().manual_seed(0), get_reduced(ARCH))
    assert {k: tuple(v.shape) for k, v in leaves(tp).items()} \
        == {k: tuple(v.shape) for k, v in leaves(ours).items()}
    a = jp["groups"]["u0"]["attn"]["qkv"]
    assert np.array_equal(
        np.asarray(jax.lax.bitcast_convert_type(a, jnp.uint16)),
        tp["groups"]["u0"]["attn"]["qkv"].view(torch.int16).numpy()
        .view(np.uint16))


# ---------------------------------------------------------------------------
# Engine invariants (the port's reference backend, CPU)
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


def test_chunked_prefill_equals_token_by_token(engine_reference_run):
    cfg, reqs, res, eng = engine_reference_run
    assert eng.step_count > 0
    # a chunk wider than every prompt: each token goes through decode
    tok_by_tok, _ = run(cfg, reqs, prefill_chunk=64)
    assert res == tok_by_tok


def test_engine_equals_each_request_alone(engine_reference_run):
    cfg, reqs, res, _ = engine_reference_run
    for r in reqs:
        alone, _ = run(cfg, [dataclasses.replace(r, arrival_step=0)])
        assert alone[r.rid] == res[r.rid], r.rid


def test_fused_decode_bit_identical_on_reference(engine_reference_run):
    cfg, reqs, res, _ = engine_reference_run
    fused, eng = run(cfg, reqs, fused_decode=True)
    assert eng.program.fused_decode and fused == res


@pytest.mark.parametrize("arch", [ARCH, "granite-moe-1b-a400m"])
def test_eviction_under_arena_pressure(arch):
    """tests/test_serving.py:203 on the port: a starved queue preempts
    the newest resident (``plan_evictions``); evicted requests resume by
    re-prefilling prompt + generated, and every output equals the
    request served alone."""
    cfg = get_reduced(arch)
    reqs = [dataclasses.replace(r, arrival_step=0, max_new_tokens=10)
            for r in mixed_requests(cfg, [13, 8, 11, 5], gen=10, seed=3)]
    kw = dict(n_slots=2, max_len=32, prefill_chunk=4)
    res, eng = run(cfg, reqs, evict_patience=3, **kw)
    assert sum(st.evictions for st in eng.sched.finished.values()) > 0, \
        "the pressure test never evicted"
    for r in reqs:
        alone, _ = run(cfg, [r], **kw)
        assert alone[r.rid] == res[r.rid], r.rid


def test_windowed_ring_wraps_inside_a_prefill_chunk():
    """tests/test_serving.py:159 on the port: a sliding-window ring of 8
    positions wraps inside 6-token chunks of 25- and 19-token prompts —
    the case models/transformer.py's per-token insert and attend in
    ``_attn_chunk`` exists for.  Chunked prefill equals token-by-token
    decode and each request served alone."""
    base = get_reduced(ARCH)
    cfg = dataclasses.replace(
        base, attention=dataclasses.replace(base.attention, window=8))
    reqs = [dataclasses.replace(r, arrival_step=0)
            for r in mixed_requests(cfg, [25, 19], gen=6, seed=4)]
    kw = dict(n_slots=2, max_len=40)
    res, eng = run(cfg, reqs, **kw)
    assert eng.cache["u0"]["attn"]["k"].shape[2] == 8      # ring, not 40
    tok_by_tok, _ = run(cfg, reqs, prefill_chunk=64, **kw)
    assert res == tok_by_tok
    for r in reqs:
        alone, _ = run(cfg, [r], **kw)
        assert alone[r.rid] == res[r.rid], r.rid


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_masked_decode_leaves_inactive_rows_unchanged(backend, fused):
    cfg = get_reduced(ARCH)
    eng = build_engine(cfg, n_slots=3, max_len=16, device="cpu",
                       kernel_backend=backend, fused_decode=fused)
    g = torch.Generator().manual_seed(5)
    for leaf in leaves(eng.cache).values():
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=g))
        else:
            leaf.fill_(-1)
    before = {k: v.clone() for k, v in leaves(eng.cache).items()}
    active = np.array([True, False, True])
    eng._decode(np.array([[3], [4], [5]], np.int32),
                np.array([5, 6, 7], np.int32), active)
    for k, v in leaves(eng.cache).items():
        assert torch.equal(v[:, 1], before[k][:, 1]), k
        assert not torch.equal(v[:, 0], before[k][:, 0]), k


# ---------------------------------------------------------------------------
# Entry points: CUDA unless asked for the CPU; never a quiet fallback
# ---------------------------------------------------------------------------


def test_build_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(get_reduced(ARCH), n_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine(get_reduced(ARCH), n_slots=2, max_len=16, device="cuda")


def test_serving_engine_without_device_raises_and_runs_on_cpu(monkeypatch):
    """ServingEngine built directly takes CUDA unless the caller asks
    for the CPU: with no device and no GPU it raises; device="cpu" serves
    the same tokens as build_engine on the CPU with the same weights."""
    cfg = get_reduced(ARCH)
    reqs = mixed_requests(cfg, [5, 9], gen=3, seed=4)
    want, ref = run(cfg, reqs, n_slots=2)
    kw = dict(n_slots=2, max_len=32, prefill_chunk=6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, ref.program, ref.params, **kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, ref.program, ref.params, device="cuda", **kw)
    eng = ServingEngine(cfg, ref.program, ref.params, device="cpu", **kw)
    assert eng.device == torch.device("cpu")
    assert all(v.device.type == "cpu" for v in leaves(eng.cache).values())
    with torch.no_grad():
        assert eng.run(reqs) == want


def test_serve_cli_on_cpu_and_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        serve.main(["--help"])
    assert e.value.code == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])
    kmm.COUNTER.reset()
    kdf.COUNTER.reset()
    assert serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                       "--prompt-lens", "4,12", "--gen", "3", "--slots", "2",
                       "--chunk", "4", "--kernel-backend", "cuda",
                       "--fused-decode"]) == 0
    out = capsys.readouterr().out
    assert "throughput" in out and "sample (req-0000)" in out
    assert kmm.COUNTER.n == 0 and kdf.COUNTER.n == 0   # CPU: plain versions


def test_bench_decode_traces_again_when_the_profiler_records_nothing(
        monkeypatch):
    """launch/bench_decode.py's per-launch split takes its trace again
    when torch.profiler recorded no device kernel in it (the card's
    profiler has been seen to), uses the first trace that has kernels,
    and stops with an error after TRACES empty ones."""
    from repro_torch.launch import bench_decode
    kern = [(0.0, 2.0, "void rt::decode::gemm_kernel<64, 0>(Args)"),
            (1.5, 3.0, "void rt::decode::attn_kernel(Args)")]
    traces = iter([[], kern])
    monkeypatch.setattr(bench_decode, "_graph", lambda fn, iters: None)
    monkeypatch.setattr(bench_decode, "_trace", lambda graph: next(traces))
    assert bench_decode.launch_ms(None, iters=1) == {
        "qkv": (0.002, 1.0), "attention": (0.001, 1.0)}
    monkeypatch.setattr(bench_decode, "_trace", lambda graph: [])
    with pytest.raises(SystemExit, match="no device kernel in 3"):
        bench_decode.launch_ms(None, iters=1)
