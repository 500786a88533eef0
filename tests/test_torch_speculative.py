"""The port's speculative serving against the JAX package, and its own
invariants.

Reduced configs (3 slots, max_len <= 32, prefill chunk 6, k = 2-3) of
qwen2-0.5b, rwkv6-1.6b (the port's reduced fields on both sides) and
granite-moe-1b-a400m.  Inputs are made from a numpy seed; the
reference's parameters reach the port through ``params_from_numpy``.

Against the JAX package:

- the speculative program's words and iBuffer image (the DRAFT column),
  fused and per-op;
- ``make_draft_step`` teacher-forced for three steps: logits within 2e-2
  and caches within 6e-2 (tests/test_torch_serving.py's tolerances);
- ``bursty_trace`` and ``diurnal_trace``: the same requests from the
  same arguments, the same errors; ``consume_spec`` and
  ``draft_config_for`` equal;
- the speculative engine's tokens against the JAX engine's (with its big
  and draft parameters carried across), for the three models and a
  qwen2 self-draft: every first token equal, at least TOKEN_AGREEMENT of
  all tokens (tests/test_torch_rwkv6.py), and the verify and acceptance
  counts equal.

The port's own invariants, on its reference backend, for the three
models: the speculative run equals the non-speculative one bit for bit
(random draft, fused decode, under eviction on a bursty trace, with a
max_len that leaves no headroom), the budget is exact; a self-draft
accepts every proposal; a verify leaves the arena bit-identical (on the
cuda backend's plain versions too); the draft row holds exactly the
state of the true sequence after every round; the serve CLI's
``--speculative`` line.
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
from repro.serving import build_engine as jbuild_engine  # noqa: E402
from repro.serving import bursty_trace as jbursty  # noqa: E402
from repro.serving import diurnal_trace as jdiurnal  # noqa: E402
from repro.serving import draft_config_for as jdraft_config  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.serving.slots import SlotPool as JSlotPool  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.phases import Phase  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import train_loop as tl  # noqa: E402
from repro_torch.serving import (Request, Scheduler, SlotPool,  # noqa: E402
                                 build_engine, bursty_trace,
                                 diurnal_trace, draft_config_for)

MESH1 = MeshSpec(axis_sizes={"data": 1, "model": 1}, batch_axes=("data",))
QWEN, RWKV, GRANITE = "qwen2-0.5b", "rwkv6-1.6b", "granite-moe-1b-a400m"
ARCHS = (QWEN, RWKV, GRANITE)
LOGIT_TOL, CACHE_TOL = 2e-2, 6e-2
TOKEN_AGREEMENT = 0.9


def jax_reduced(arch):
    """The reference's config with the port's reduced fields (rwkv6: the
    port's reduced widths differ from the reference's reduced preset)."""
    if arch != RWKV:
        return jget_reduced(arch)
    ours, full = get_reduced(arch), jget_config(arch)
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
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def requests(cfg, lens, gen, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=f"r{i}", prompt=tuple(int(x) for x in rng.integers(
        0, cfg.vocab_size, size=n)), max_new_tokens=gen, arrival_step=i)
        for i, n in enumerate(lens)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The engines here run many small ops on a few rows, which intra-op
    threads do not speed up; beside other test processes on the same
    cores, their spinning threads slow this file many times over.  One
    thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(cfg, reqs, **kw):
    kw = {"n_slots": 3, "max_len": 32, "prefill_chunk": 6, "seed": 0,
          "device": "cpu", **kw}
    eng = build_engine(cfg, **kw)
    with torch.no_grad():
        return eng.run(reqs), eng


# ---------------------------------------------------------------------------
# Program words, draft config, traces, scheduler: equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_program_words_match_reference(arch, fused):
    cfg, jcfg = get_reduced(arch), jax_reduced(arch)
    shape, jshape = (ShapeConfig("serve", 32, 3, "decode"),
                     JShape("serve", 32, 3, "decode"))
    prog = compile_program(cfg, shape, fused_decode=fused, speculative=True)
    jprog = jcompile(jcfg, jshape, MESH1, fused_decode=fused,
                     speculative=True)
    keys = ("op", "phase", "strategy", "dtype", "rounding", "kernel")
    entries = prog.ibuffer_entries()
    assert entries == [{k: e[k] for k in keys}
                       for e in jprog.ibuffer_entries()]
    assert {e["phase"] for e in entries} == {"PREFILL", "DECODE", "DRAFT"}
    for op in jprog.plan.ops:
        assert dataclasses.asdict(prog.pe_word(op)) \
            == dataclasses.asdict(jprog.pe_word(op)), op
        # the draft model's step stays the per-op matvec, fused or not
        assert prog.pe_word(op).kernel_for(Phase.DRAFT) in ("matvec", "vpu")
    # the flag is opt-in: a default program has no DRAFT column
    plain = compile_program(cfg, shape, fused_decode=fused)
    assert {e["phase"] for e in plain.ibuffer_entries()} \
        == {"PREFILL", "DECODE"}


@pytest.mark.parametrize("arch", ARCHS)
def test_draft_config_matches_reference(arch):
    ours, theirs = draft_config_for(get_reduced(arch)), \
        jdraft_config(jax_reduced(arch))
    assert ours.n_layers == theirs.n_layers == 1
    assert ours.name == theirs.name
    for f in dataclasses.fields(ours):
        if f.name == "notes":            # prose about each package's kernels
            continue
        got, want = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(got):
            # the port's sub-configs keep the fields of what it runs
            # (its SSM config: rwkv6's, not Mamba's)
            g, w = dataclasses.asdict(got), dataclasses.asdict(want)
            assert g == {k: w[k] for k in g}, f.name
        else:
            assert got == want, f.name
    full = draft_config_for(get_config(arch))
    assert full.d_model == get_config(arch).d_model and full.n_layers == 1


def _reqs(trace):
    return [(r.rid, r.prompt, r.max_new_tokens, r.arrival_step, r.slo)
            for r in trace]


@pytest.mark.parametrize("kw", [
    dict(n=22, burst_size=5, burst_gap_steps=16, seed=1),
    dict(n=12, prompt_lens=(8, 32), gen_tokens=4, burst_size=4, seed=9),
    dict(n=64, prompt_lens=(16, 128), gen_tokens=16, burst_size=64, seed=0),
    dict(n=7, burst_size=1, burst_gap_steps=1, seed=3)])
def test_bursty_trace_matches_reference(kw):
    kw = dict(kw)
    n = kw.pop("n")
    assert _reqs(bursty_trace(n, vocab_size=257, **kw)) \
        == _reqs(jbursty(n, vocab_size=257, **kw))


@pytest.mark.parametrize("kw", [
    dict(n=60, seed=2),
    dict(n=40, prompt_lens=(4, 32), batch_frac=0.5, prefix_pool=3,
         prefix_len=8, seed=4),
    dict(n=30, period_steps=10_000, peak_interarrival_steps=2.0,
         trough_interarrival_steps=2.0, tail_prob=0.3, tail_shape=1.1,
         seed=3),
    dict(n=25, day_phase=0.5, batch_frac=0.2, seed=5)])
def test_diurnal_trace_matches_reference(kw):
    kw = dict(kw)
    n = kw.pop("n")
    assert _reqs(diurnal_trace(n, vocab_size=301, **kw)) \
        == _reqs(jdiurnal(n, vocab_size=301, **kw))


@pytest.mark.parametrize("fn, jfn, kw", [
    (bursty_trace, jbursty, dict(prompt_lens=(5, 4))),
    (bursty_trace, jbursty, dict(burst_size=0)),
    (bursty_trace, jbursty, dict(burst_gap_steps=0)),
    (diurnal_trace, jdiurnal, dict(prompt_lens=(0, 4))),
    (diurnal_trace, jdiurnal, dict(prefix_pool=2, prefix_len=600)),
    (diurnal_trace, jdiurnal, dict(peak_interarrival_steps=9.0)),
    (diurnal_trace, jdiurnal, dict(day_phase=1.0))])
def test_trace_errors_match_reference(fn, jfn, kw):
    with pytest.raises(ValueError) as ours:
        fn(4, vocab_size=50, **kw)
    with pytest.raises(ValueError) as theirs:
        jfn(4, vocab_size=50, **kw)
    assert str(ours.value) == str(theirs.value)


def test_consume_spec_matches_reference():
    """The same admissions and commits (a prefill chunk, runs of 1 to 4
    tokens, one past the budget) leave both schedulers' request states,
    results and slots equal."""
    def states(sched):
        return sorted((s.req.rid, s.phase, s.slot, s.pos, tuple(s.generated))
                      for s in [*sched.active.values(),
                                *sched.finished.values()])

    rng = np.random.default_rng(0)
    ours = Scheduler(SlotPool(2), prefill_chunk=4)
    theirs = JScheduler(JSlotPool(2), prefill_chunk=4)
    for i, (plen, gen) in enumerate(((6, 5), (3, 7))):
        prompt = tuple(int(x) for x in rng.integers(0, 99, size=plen))
        ours.submit(Request(f"r{i}", prompt, gen))
        theirs.submit(JRequest(f"r{i}", prompt, gen))
    ours.admit(0)
    theirs.admit(0)
    out = []
    for sched in (ours, theirs):
        got = []
        for st in sorted(sched.active.values(), key=lambda s: s.req.rid):
            while st.remaining > 1:
                sched.consume(st, 0)
            got.append(sched.consume(st, 11))
            for n in (1, 3, 4, 2):
                if st.done:
                    break
                got.append(sched.consume_spec(
                    st, [int(x) for x in rng.integers(0, 99, size=n)]))
        out.append((got, states(sched), sched.results(),
                    sched.pool.free_count))
        rng = np.random.default_rng(0)
        rng.integers(0, 99, size=9)
    assert out[0] == out[1]
    assert out[0][2]["r0"] and len(out[0][2]["r0"]) == 5


# ---------------------------------------------------------------------------
# The DRAFT step, teacher-forced, against the reference's
# ---------------------------------------------------------------------------

B, MAX_LEN = 2, 16


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_draft_step_matches_reference(arch, backend):
    """The default draft (one layer) of each model, three DRAFT steps from
    an empty cache on both sides: logits and caches within the serving
    tolerances; the port's cuda backend runs its kernels' plain
    versions on CPU tensors."""
    jcfg = jdraft_config(jax_reduced(arch))
    cfg = draft_config_for(get_reduced(arch))
    shape = JShape("serve-draft", MAX_LEN, B, "decode")
    jprog = jcompile(jcfg, shape, MESH1, speculative=True)
    jparams = jtl.cast_params(jtfm.init(jax.random.PRNGKey(1), jcfg),
                              jnp.bfloat16)
    jstep = jax.jit(jtl.make_draft_step(jcfg, jprog, None))
    prog = compile_program(cfg, ShapeConfig("serve-draft", MAX_LEN, B,
                                            "decode"), speculative=True)
    step = tl.make_draft_step(cfg, prog, kernel_backend=backend)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(3, B, 1)).astype(np.int32)
    jcache = jtfm.init_cache(jcfg, B, MAX_LEN)
    cache = tfm.init_cache(cfg, B, MAX_LEN)
    with torch.no_grad():
        for t in range(3):
            jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[t]),
                               jnp.full((B,), t, jnp.int32))
            lg, _ = step(tparams, cache, torch.from_numpy(toks[t]),
                         torch.full((B,), t, dtype=torch.int32))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
    want = {k: to_np(v) for k, v in leaves(jcache).items()}
    got = leaves(cache)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k.endswith("pos"):
            np.testing.assert_array_equal(to_np(got[k]), w)
        else:
            np.testing.assert_allclose(to_np(got[k]), w, atol=CACHE_TOL,
                                       rtol=CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_draft_step_leaves_inactive_rows_unchanged(arch):
    cfg = draft_config_for(get_reduced(arch))
    prog = compile_program(cfg, ShapeConfig("d", 16, 3, "decode"),
                           speculative=True)
    step = tl.make_draft_step(cfg, prog)
    params = tl.cast_params(tfm.init(torch.Generator().manual_seed(0), cfg),
                            torch.bfloat16)
    cache = tfm.init_cache(cfg, 3, 16)
    g = torch.Generator().manual_seed(5)
    for leaf in leaves(cache).values():
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=g))
    before = {k: v.clone() for k, v in leaves(cache).items()}
    with torch.no_grad():
        step(params, cache, torch.tensor([[3], [4], [5]], dtype=torch.int32),
             torch.tensor([5, 6, 7], dtype=torch.int32),
             torch.tensor([False, True, False]))
    for k, v in leaves(cache).items():
        assert torch.equal(v[:, 0], before[k][:, 0]), k
        assert torch.equal(v[:, 2], before[k][:, 2]), k
        assert not torch.equal(v[:, 1], before[k][:, 1]), k


# ---------------------------------------------------------------------------
# The engine against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch, self_draft", [
    (QWEN, False), (RWKV, False), (GRANITE, False), (QWEN, True)])
def test_speculative_engine_tokens_match_jax_engine(arch, self_draft):
    """The default draft mostly rejects; the self-draft accepts up to the
    budget, where the port proposes fewer than k - 1 tokens and the
    reference k - 1.  max_len leaves k positions of headroom past every
    request, so the reference's verify never wraps the ring, and the
    verify and acceptance counts equal the reference's too."""
    jcfg = jax_reduced(arch)
    reqs = requests(jcfg, [13, 4, 20, 7], gen=6, seed=2)
    assert max(len(r.prompt) + r.max_new_tokens for r in reqs) + 3 <= 32
    spec = dict(speculative=3)
    if self_draft:
        spec.update(draft_cfg=jcfg, draft_seed=0)
    jeng = jbuild_engine(jcfg, n_slots=3, max_len=32, prefill_chunk=6,
                         seed=0, **spec)
    jres = jeng.run([dataclasses.replace(r) for r in reqs])
    carry = dict(params=params_from_numpy(
        jax.tree.map(np.asarray, jeng.params), "cpu"),
        draft_params=params_from_numpy(
            jax.tree.map(np.asarray, jeng.draft_params), "cpu"))
    if self_draft:
        carry["draft_cfg"] = get_reduced(arch)
    for backend, fused in (("reference", False), ("cuda", True)):
        res, eng = run(get_reduced(arch), reqs, speculative=3,
                       kernel_backend=backend, fused_decode=fused, **carry)
        assert eng.spec_stats["verifies"] > 0
        assert all(res[r.rid][0] == jres[r.rid][0] for r in reqs)
        same = sum(a == b for r in reqs
                   for a, b in zip(res[r.rid], jres[r.rid]))
        assert same >= TOKEN_AGREEMENT * sum(len(jres[r.rid]) for r in reqs)
        assert all(len(res[r.rid]) == r.max_new_tokens for r in reqs)
        assert eng.spec_stats == jeng.spec_stats
    if self_draft:
        assert jeng.spec_stats["accepted"] == sum(
            r.max_new_tokens - 1 for r in reqs)


# ---------------------------------------------------------------------------
# The port's invariants (reference backend, CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def base_run(request):
    cfg = get_reduced(request.param)
    reqs = requests(cfg, [9, 4, 13, 7], gen=8, seed=3)
    res, _ = run(cfg, reqs)
    return cfg, reqs, res


def test_speculative_bit_identical_random_draft(base_run):
    """The default draft (one layer, its own seed) mostly disagrees with
    the big model: every verify exercises reject and rollback, and the
    committed stream is still the sequential greedy stream, with every
    budget exact."""
    cfg, reqs, want = base_run
    res, eng = run(cfg, reqs, speculative=3)
    assert eng.spec_stats["verifies"] > 0
    assert res == want
    for r in reqs:
        assert len(res[r.rid]) == r.max_new_tokens
    assert eng.nonfinite_logits == 0


def test_speculative_self_draft_accepts_everything(base_run):
    """draft == the big model (same config, same weights): every proposal
    verifies — accepted equals every token after the first, and
    accepted / verify comes near k."""
    cfg, reqs, want = base_run
    res, eng = run(cfg, reqs, speculative=3, draft_cfg=cfg, draft_seed=0)
    assert res == want
    s = eng.spec_stats
    assert s["accepted"] == sum(r.max_new_tokens - 1 for r in reqs)
    assert s["accepted"] / s["verifies"] > 2.0


def test_speculative_with_fused_decode(base_run):
    cfg, reqs, want = base_run
    res, eng = run(cfg, reqs, speculative=2, fused_decode=True)
    assert eng.program.fused_decode and eng.program.speculative
    assert res == want


def test_speculative_without_headroom_in_the_ring(base_run):
    """max_len = the longest prompt + its budget: a verify chunk that ran
    past max_len would wrap the KV ring onto the row's first entries;
    the proposals stop at the budget, so the tokens stay the sequential
    ones."""
    cfg, reqs, want = base_run
    tight = max(len(r.prompt) for r in reqs) + 8
    res, eng = run(cfg, reqs, max_len=tight, speculative=3)
    assert eng.spec_stats["verifies"] > 0 and res == want


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_under_eviction_on_a_bursty_trace(arch):
    """One burst overloads a 2-slot arena: the starved queue evicts
    residents (``evict_patience``), which resume by re-prefilling prompt +
    generated with a fresh draft row; every request's tokens equal its
    tokens served alone without speculation."""
    cfg = get_reduced(arch)
    reqs = bursty_trace(5, vocab_size=cfg.vocab_size, prompt_lens=(4, 14),
                        gen_tokens=9, burst_size=5, seed=6)
    kw = dict(n_slots=2, max_len=32, prefill_chunk=4)
    res, eng = run(cfg, reqs, evict_patience=2, speculative=3, **kw)
    assert sum(st.evictions for st in eng.sched.finished.values()) > 0
    assert eng.spec_stats["verifies"] > 0
    for r in reqs:
        alone, _ = run(cfg, [r], **kw)
        assert res[r.rid] == alone[r.rid], r.rid


def _spy(eng, name, after):
    """Wrap engine method `name`; after(args, state) runs after each
    call with what before() returned."""
    fn = getattr(eng, name)
    calls = []

    def wrap(*a):
        before = {k: v.clone() for k, v in leaves(eng.cache).items()}
        out = fn(*a)
        after(a, before)
        calls.append(a)
        return out

    setattr(eng, name, wrap)
    return calls


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_leaves_the_arena_bit_identical(arch, backend):
    cfg = get_reduced(arch)
    reqs = requests(cfg, [9, 4, 13], gen=6, seed=4)
    eng = build_engine(cfg, n_slots=3, max_len=32, prefill_chunk=6,
                       device="cpu", kernel_backend=backend, speculative=3)

    def same(_, before):
        for k, v in leaves(eng.cache).items():
            assert torch.equal(v, before[k]), k

    calls = _spy(eng, "_verify", same)
    with torch.no_grad():
        res = eng.run(reqs)
    assert len(calls) == eng.spec_stats["verifies"] > 0
    assert all(len(res[r.rid]) == 6 for r in reqs)


@pytest.mark.parametrize("arch", ARCHS)
def test_draft_row_holds_the_true_sequence_after_each_round(arch):
    """After every round the draft's row is exactly the state of the true
    sequence up to the round's feed (its catch-up, then the proposals
    rolled back): a fresh one-row draft cache fed those tokens one DRAFT
    step at a time equals it bit for bit, and the other rows are left as
    they were."""
    cfg = get_reduced(arch)
    reqs = requests(cfg, [9, 4, 13], gen=6, seed=5)
    eng = build_engine(cfg, n_slots=3, max_len=32, prefill_chunk=6,
                       device="cpu", speculative=3)
    step = tl.make_draft_step(eng.draft_cfg, eng.draft_program)
    fn = eng._spec_round
    rounds = []

    def wrap(st, s):
        slot, p, seq = st.slot, st.pos, st.seq
        other = {k: torch.cat([v[:, :slot], v[:, slot + 1:]], dim=1)
                 for k, v in leaves(eng.draft_cache).items()}
        out = fn(st, s)
        want = tfm.init_cache(eng.draft_cfg, 1, eng.max_len)
        for q in range(p):
            step(eng.draft_params, want, torch.tensor([[seq[q]]],
                                                      dtype=torch.int32),
                 torch.tensor([q], dtype=torch.int32))
        for k, v in leaves(eng.draft_cache).items():
            assert torch.equal(v[:, slot:slot + 1], leaves(want)[k]), k
            assert torch.equal(torch.cat([v[:, :slot], v[:, slot + 1:]],
                                         dim=1), other[k]), k
        rounds.append(p)
        return out

    eng._spec_round = wrap
    with torch.no_grad():
        eng.run(reqs)
    assert len(rounds) == eng.spec_stats["verifies"] > 0


def test_speculative_needs_a_draft():
    cfg = get_reduced(QWEN)
    _, eng = run(cfg, [])
    with pytest.raises(ValueError, match="needs a draft"):
        type(eng)(cfg, eng.program, eng.params, n_slots=3, max_len=32,
                  device="cpu", speculative=2)


def test_serve_cli_speculative_on_cpu(capsys):
    assert serve.main(["--reduced", "--speculative", "3", "--device", "cpu",
                       "--requests", "3", "--prompt-lens", "4,12", "--gen",
                       "5", "--slots", "2", "--chunk", "4",
                       "--evict-patience", "3"]) == 0
    out = capsys.readouterr().out
    assert "speculative k=3: verifies=" in out and "accepted/verify" in out
    assert "sample (req-0000)" in out


def test_profile_serve_splits_device_time_by_engine_call():
    """launch/profile_serve.py gives each kernel's time to the engine
    call whose ``record_function`` range holds its start (the calls
    synchronise before they end), the rest to None; the ranges' own
    device-side annotations count nowhere."""
    from types import SimpleNamespace as NS

    from repro_torch.launch import profile_serve as ps

    def ev(name, dev, t0, t1):
        return NS(name=name, device_type=f"DeviceType.{dev}",
                  time_range=NS(start=t0, end=t1))

    events = [ev("serve:draft", "CPU", 0, 10), ev("serve:draft", "CUDA", 1, 9),
              ev("gemv", "CUDA", 2, 5), ev("add", "CUDA", 6, 7),
              ev("serve:verify", "CPU", 20, 40), ev("gemm", "CUDA", 21, 30),
              ev("stray", "CUDA", 12, 15), ev("aten::mm", "CPU", 22, 23)]
    assert ps._device_by_range(events) == {"draft": 4, "verify": 9,
                                           None: 3}
