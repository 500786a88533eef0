"""The port's jamba training slice against the JAX package, on the CPU.

The reduced jamba (d 64, 4 heads of 16, 4 experts top-2, d_state 4) is
cut to one period of its pattern (8 layers: attention at unit 0, Mamba
at 1-7, a MoE FF on the odd units) on both sides, so JAX compiles each
function once (cached).  Inputs are numpy from a seed, or the
reference's own TrainState carried across.  The cuda backend's kernels
run their plain versions here (CPU tensors).

- ``selective_scan_bwd_plain`` (the written-out reverse recurrence)
  against ``jax.vjp`` of the reference's ``selective_scan`` (S = 128
  takes its 64-token re-materialised chunks) and against torch autograd
  through ``selective_scan_plain``, at N 4 / 8 / 16, S 1 / 7 / 128, f32
  and bf16 x, and under decay strong enough that exp(dt A) is 0;
- ``selective_scan_train`` (the autograd Function) returning the plain
  backward's results in the inputs' dtypes, refusing a carried state,
  checking its operands; ``selective_scan_bwd_plan`` and the C entry;
- ``mamba_block``'s gradients against ``jax.grad`` of the reference's;
- the slice: step-0 loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` under ``fp32``
  and ``paper_sr_bf16`` on both backends (the port held to JAX's expert
  selection, the cuda backend's UP fed the reference's SR bits for its
  own dY), and the step's loss and gradient norm against the
  reference's ``make_train_step``; then ``fp32`` steps tracking it;
- remat ``none`` / ``block`` bit-equal, the full-width state shapes
  against the reference's ``eval_shape``, the one-card cut, and the CLI.

Tolerances, each about 5x or more above the gap measured on the CPU
(noted beside it): every comparison is the largest |difference| of an
output over the largest |value| of the reference's output.
"""
import dataclasses
import functools
import re
import types
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.core.dataflow import MeshSpec  # noqa: E402
from repro.core.program import compile_program as jcompile  # noqa: E402
from repro.engine import PEContext as JContext  # noqa: E402
from repro.engine import op_key as jop_key  # noqa: E402
from repro.engine import up_key as jup_key  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.layers import Sharder  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro_torch.checkpoint.convert import state_from_numpy  # noqa: E402
from repro_torch.configs import (TrainConfig, get_config,  # noqa: E402
                                 get_reduced)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.phases import Phase  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.engine import PEContext  # noqa: E402
from repro_torch.engine import dispatch  # noqa: E402
from repro_torch.kernels import selective_scan as kss  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import train_loop as tl  # noqa: E402

JAMBA = "jamba-v0.1-52b"
PERIOD = 8
MESH1 = MeshSpec(axis_sizes={"data": 1, "model": 1}, batch_axes=("data",))
KEY = jax.random.PRNGKey(7)
# the reference's jitted functions compile without LLVM's expensive
# passes: the same HLO and IEEE arithmetic, in about a third of the time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")
# selective_scan_bwd_plain against JAX's vjp and torch autograd, f32
# results: f32 recurrences in another order, sums in f64 here (measured
# <= 2.5e-7)
BWD_F32_REL = 5e-6
# bf16 x: JAX rounds dx to bf16 (half a bf16 ulp, 2^-9 of the value);
# the other gradients stay f32
BWD_BF16_REL = 2e-2
# mamba_block: f32 (measured <= 7.1e-7: the softplus and A's exp run in
# f64 here, in f32 there), bf16 (measured <= 2.5e-2: bf16 activations
# and gradients rounded at other places)
BLOCK_F32_REL, BLOCK_BF16_REL = 1e-5, 0.1
# step 0, (loss, each gradient leaf, gradient norm): fp32 (measured
# 8.5e-8, <= 5.8e-6, <= 3.0e-7); paper_sr_bf16 (measured <= 5.8e-5,
# <= 9.5e-2 — unit 0's norm scale, a sum over every token of terms that
# nearly cancel, its bf16 chains rounded at other places in the two
# packages; the cuda backend's SR dW against the reference's nearest —
# and <= 4.1e-3)
STEP0_TOL = {"fp32": (1e-6, 5e-5, 2e-6),
             "paper_sr_bf16": (5e-4, 0.3, 2e-2)}
B0, S0 = 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops on a few rows, which intra-op threads do not speed
    up; beside other test processes on the same cores their spinning
    threads slow this file down.  One thread here, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel(got, want) -> float:
    g, w = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype and bits."""
    if a.dtype == jnp.bfloat16:
        bits = np.asarray(jax.lax.bitcast_convert_type(a, jnp.uint16))
        return torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# selective_scan_bwd_plain
# ---------------------------------------------------------------------------


def scan_case(S, N, dtype, strong=False, B=2, di=24, seed=0):
    """JAX and torch copies of x (in `dtype`), dt, A, B, C, D and dy.
    `strong`: dt >= 300, so dt A <= -150 and exp(dt A) is 0 in f32."""
    rng = np.random.default_rng(seed + 10 * S + N)
    x = rng.standard_normal((B, S, di))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) - 1.0))
    if strong:
        dt = dt + 300.0
    A = -np.tile(np.arange(1, N + 1), (di, 1)) * rng.uniform(0.5, 1.5,
                                                             (di, N))
    Bm, Cm = rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))
    D = rng.uniform(0.5, 1.5, di)
    dy = rng.standard_normal((B, S, di))
    j = [jnp.asarray(x, jnp.float32).astype(getattr(jnp, dtype))] + [
        jnp.asarray(a, jnp.float32) for a in (dt, A, Bm, Cm, D, dy)]
    return j, [to_torch(a) for a in j]


SCAN_CASES = [(S, N, dtype, False) for S in (1, 7, 128) for N in (4, 8, 16)
              for dtype in ("float32", "bfloat16")] + [
    (40, 4, "float32", True), (40, 16, "bfloat16", True)]


def _case_id(c):
    S, N, dtype, strong = c
    return f"S{S}-N{N}-{dtype}" + ("-strong" if strong else "")


@pytest.mark.parametrize("case", SCAN_CASES, ids=_case_id)
def test_selective_scan_bwd_plain_matches_jax_vjp(case):
    S, N, dtype, strong = case
    j, args = scan_case(S, N, dtype, strong)
    if strong:
        assert not torch.exp(args[1][..., None] * args[2]).any()
    want = jax.jit(lambda *a: jax.vjp(
        lambda *b: jssm.selective_scan(*b)[0], *a[:6])[1](a[6]),
        compiler_options=FAST_COMPILE)(*j)
    got = kss.selective_scan_bwd_plain(*args)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert torch.isfinite(g).all(), name
        tol = BWD_F32_REL if w.dtype == jnp.float32 else BWD_BF16_REL
        assert rel(g, w) <= tol, (name, rel(g, w))


@pytest.mark.parametrize("case", [c for c in SCAN_CASES
                                  if c[2] == "float32"], ids=_case_id)
def test_selective_scan_bwd_plain_matches_torch_autograd(case):
    """Autograd through the forward's plain version (f32 leaves holding
    the same values)."""
    S, N, _, strong = case
    _, args = scan_case(S, N, "float32", strong, seed=1)
    leaves = [t.clone().requires_grad_() for t in args[:6]]
    y, _ = kss.selective_scan_plain(*leaves)
    want = torch.autograd.grad((y * args[6]).sum(), leaves)
    got = kss.selective_scan_bwd_plain(*args)
    for name, g, w in zip(GRADS, got, want):
        if not w.any():
            # dA from h_{-1} = 0 at S = 1, or from a_t = 0
            assert not g.any(), name
            continue
        assert rel(g, w) <= BWD_F32_REL, (name, rel(g, w))


# ---------------------------------------------------------------------------
# selective_scan_train, the wrapper, the plan, the C entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_train_returns_the_plain_gradients_in_the_inputs_dtypes(
        dtype, plain):
    _, args = scan_case(9, 8, dtype, seed=3)
    ops, dy = args[:6], args[6]
    leaves = [t.clone().requires_grad_() for t in ops]
    kss.COUNTER.reset()
    kss.BWD_COUNTER.reset()
    y = kss.selective_scan_train(*leaves, plain=plain)
    assert torch.equal(y, kss.selective_scan_plain(*ops)[0])
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    # no launch on CPU tensors
    assert kss.COUNTER.n == kss.BWD_COUNTER.n == 0
    want = kss.selective_scan_bwd_plain(*ops, dy)
    for g, leaf, w in zip(grads, leaves, want):
        assert g.dtype == leaf.dtype
        assert torch.equal(g, w.to(leaf.dtype))


def test_selective_scan_train_refuses_a_carried_state():
    _, args = scan_case(4, 4, "float32")
    state = torch.zeros((2, 24, 4), requires_grad=True)
    with pytest.raises(ValueError, match="carried state"):
        kss.selective_scan_train(*args[:6], state)


def test_selective_scan_train_and_bwd_check_their_operands():
    _, (x, dt, A, Bm, Cm, D, dy) = scan_case(4, 4, "float32")
    with pytest.raises(TypeError):
        kss.selective_scan_train(x.half(), dt, A, Bm, Cm, D)
    with pytest.raises(ValueError):
        kss.selective_scan_train(x, dt, A, Bm[:, :2], Cm, D)
    with pytest.raises(TypeError, match="dy"):
        kss.selective_scan_bwd(x, dt, A, Bm, Cm, D, dy.double())
    with pytest.raises(TypeError, match="dy"):
        kss.selective_scan_bwd(x, dt, A, Bm, Cm, D, dy[:, :2].contiguous())
    with pytest.raises(TypeError, match="contiguous"):
        kss.selective_scan_bwd(x.transpose(0, 1).contiguous().transpose(0, 1),
                               dt, A, Bm, Cm, D, dy)
    with pytest.raises(ValueError, match="A"):
        kss.selective_scan_bwd(x, dt, A[:2].contiguous(), Bm, Cm, D, dy)
    with pytest.raises(ValueError, match="meta"):
        kss.selective_scan_bwd(*(t.to("meta") for t in (x, dt, A, Bm, Cm, D,
                                                        dy)))


def _owners(plan, di, N):
    """(d, n, live) of every (block x, thread, state of the thread) as
    csrc/selective_scan_bwd.cu assigns them: a block's channels in
    order, a channel's lanes in order, four consecutive states a lane."""
    bx = np.arange(plan.grid[0])[:, None, None]
    tid = np.arange(plan.threads)[None, :, None]
    d = np.broadcast_to(bx * plan.channels + tid // plan.lanes,
                        (plan.grid[0], plan.threads, 4))
    n = np.broadcast_to((tid % plan.lanes) * 4 + np.arange(4), d.shape)
    return d, n, d < di


@settings(deadline=None, derandomize=True, max_examples=80)
@given(B=st.integers(1, 40), S=st.integers(1, 600), di=st.integers(1, 900),
       N=st.sampled_from(kss.D_STATES))
def test_selective_scan_bwd_plan_covers_every_channel_and_token(B, S, di, N):
    """Every (b, d, n) is one state of one lane of one block; every token
    in one tile of at most BWD_TILE; blocks whole warps of at most
    MAX_THREADS; the shared memory the kernel lays out, within a block's
    227 KB, and two blocks an SM."""
    p = kss.selective_scan_bwd_plan(B, S, di, N)
    assert p.lanes * 4 == N and 32 % p.lanes == 0
    assert p.threads == p.channels * p.lanes
    assert p.threads % 32 == 0 and 64 <= p.threads <= kss.MAX_THREADS
    assert p.channels % 4 == 0
    assert p.grid == (-(-di // p.channels), B)
    assert 1 <= p.tile <= min(S, kss.BWD_TILE)
    tiles = -(-S // p.tile)
    assert (tiles - 1) * p.tile < S <= tiles * p.tile
    assert p.smem == kss.bwd_smem_bytes(N, p.channels, p.tile)
    assert 2 * (p.smem + 1024) <= 228 * 1024
    d, n, live = _owners(p, di, N)
    count = np.zeros((di, N), dtype=np.int64)
    np.add.at(count, (d[live], n[live]), 1)
    assert (count == 1).all()


def test_selective_scan_bwd_plan_at_jamba_training_shapes():
    """B 4 x S 256 (the training step): 128 x 4 blocks of 256 threads,
    two blocks an SM; B 2 x S 64 (chip_smoke.py's step-0 check): blocks
    halved to two per SM's worth of the grid; a d_state the kernel is
    not built for is refused."""
    p = kss.selective_scan_bwd_plan(4, 256, 8192, 16)
    assert (p.grid, p.threads, p.tile, p.smem) == ((128, 4), 256, 8, 105472)
    q = kss.selective_scan_bwd_plan(2, 64, 8192, 16)
    assert q.grid == (256, 2) and q.threads == 128
    with pytest.raises(ValueError):
        kss.selective_scan_bwd_plan(1, 1, 64, 6)


def test_selective_scan_bwd_source_agrees_with_the_wrapper():
    """The constants and the shared-memory layout the plan mirrors, and
    the C entry's argument count against the ctypes binding."""
    src = (Path(kss.__file__).resolve().parent.parent / "csrc"
           / "selective_scan_bwd.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(consts["MAX_THREADS"]) == kss.MAX_THREADS
    assert "tile * (3 * ch + 2 * N + 3 * N * ch) * (int)sizeof(float)" in src
    sig = re.search(r'extern "C" int selective_scan_bwd_launch\(([^)]*)\)',
                    src).group(1)
    fn = types.SimpleNamespace()
    kss._bind_bwd(types.SimpleNamespace(selective_scan_bwd_launch=fn))
    assert len(fn.argtypes) == sig.count(",") + 1


# ---------------------------------------------------------------------------
# mamba_block
# ---------------------------------------------------------------------------


BLOCK_B, BLOCK_S = 2, 128


def _block_configs():
    """The reduced jamba with jamba's d_conv 4 on both sides."""
    cfg, jcfg = get_reduced(JAMBA), jget_reduced(JAMBA)
    return (dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                             d_conv=4)),
            dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm,
                                                              d_conv=4)))


@functools.lru_cache(maxsize=None)
def _reference_block_grads(dtype):
    """(x, params, c, dx, dparams) of the reference's mamba_block: the
    gradients of sum(out * c), from no state, in `dtype` (S = 128 takes
    the scan's 64-token re-materialised chunks)."""
    _, jcfg = _block_configs()
    rng = np.random.default_rng(5)
    p = {k: np.array(v) for k, v in jssm.mamba_params(
        jcfg, jax.random.PRNGKey(2)).items()}
    di = p["D"].shape[0]
    p["dt_bias"] = (0.3 * rng.standard_normal(di)).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, di).astype(np.float32)
    x = rng.standard_normal((BLOCK_B, BLOCK_S, jcfg.d_model)).astype(
        np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p)
    jx = jnp.asarray(x).astype(jdt)

    def jloss(xx, pp):
        out, _ = jssm.mamba_block(jcfg, xx, pp, Sharder())
        return jnp.sum(out.astype(jnp.float32) * c)

    jgx, jgp = jax.jit(jax.grad(jloss, argnums=(0, 1)),
                       compiler_options=FAST_COMPILE)(jx, jp)
    return jx, jp, c, jgx, jgp


def test_softplus_and_its_gradient_match_jax_at_zero_and_the_tails():
    """dt's softplus against jax.nn.softplus in f32, value and gradient
    within 1e-6 (relative, or absolute below 1): at x = 0 and -0 the
    gradient is logaddexp's 1/2 (clamp's and abs's subgradients summed
    would give 1; an f32 pre-activation of exactly 0 occurs in training,
    where a product equals minus dt_bias), and on both tails."""
    x = np.array([0.0, -0.0, 1e-30, -1e-30, -3.0, 2.0, 20.5, -20.5, 30.0,
                  -800.0, 800.0], np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    y = ssm._softplus(tx)
    (g,) = torch.autograd.grad(y.sum(), tx)
    want_y = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    want_g = np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(jnp.asarray(x)))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-6)
    assert g[0] == g[1] == 0.5
    with torch.no_grad():
        assert torch.equal(ssm._softplus(tx), y.detach())


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_grads_match_jax(dtype, backend, monkeypatch):
    """Gradients of sum(out * c) with respect to x and every mixer leaf
    (the scan's through selective_scan_train: on the cuda backend its
    wrapper, selective_scan_bwd, on the reference backend the plain
    reverse recurrence), from no state: the port's words (fp32 or
    bf16_nearest) against the reference's plain dots in x's dtype."""
    cfg, _ = _block_configs()
    jx, jp, c, jgx, jgp = _reference_block_grads(dtype)
    calls = []
    for name in ("selective_scan_bwd", "selective_scan_bwd_plain"):
        real = getattr(kss, name)
        monkeypatch.setattr(kss, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    prog = compile_program(cfg, ShapeConfig("t", BLOCK_S, BLOCK_B, "train"),
                           precision="fp32" if dtype == "float32"
                           else "bf16_nearest")
    sh = PEContext(prog, backend=backend, phase=Phase.FF)
    tp = {k: to_torch(v).requires_grad_() for k, v in jp.items()}
    tx = to_torch(jx).requires_grad_()
    out = ssm.mamba_block(cfg, tx, tp, sh)
    assert out.dtype == tx.dtype
    grads = torch.autograd.grad(
        (out.float() * torch.from_numpy(c)).sum(), [tx, *tp.values()])
    # the cuda backend's wrapper takes its plain version on CPU tensors
    assert calls == (["selective_scan_bwd", "selective_scan_bwd_plain"]
                     if backend == "cuda" else ["selective_scan_bwd_plain"])
    tol = BLOCK_F32_REL if dtype == "float32" else BLOCK_BF16_REL
    for name, g, want in zip(["x", *tp], grads, [jgx, *jgp.values()]):
        assert g.dtype == tx.dtype, name
        assert rel(g, want) <= tol, (name, rel(g, want))


# ---------------------------------------------------------------------------
# The slice: one period of the reduced jamba
# ---------------------------------------------------------------------------


def _configs():
    return (dataclasses.replace(get_reduced(JAMBA), n_layers=PERIOD),
            dataclasses.replace(jget_reduced(JAMBA), n_layers=PERIOD))


def _programs(precision):
    cfg, jcfg = _configs()
    prog = compile_program(cfg, ShapeConfig("t", S0, B0, "train"),
                           precision=precision)
    jprog = jcompile(jcfg, JShape("t", S0, B0, "train"), MESH1,
                     precision=precision)
    return cfg, jcfg, prog, jprog


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The reference's f32 parameters of the period (its init, once)."""
    return jtfm.init(jax.random.PRNGKey(0), _configs()[1])


@functools.lru_cache(maxsize=None)
def _jax_train_step(precision, metrics_only: bool):
    """The reference's make_train_step (adamw, remat block), jitted, and
    its initial state (init_state's, from the shared f32 init); with
    `metrics_only` just its (loss, grad_norm), the update left out by
    XLA."""
    _, jcfg, _, jprog = _programs(precision)
    jtrain = JTrain(optimizer="adamw", lr=3e-3, precision=precision,
                    remat="block")
    step, opt = jtl.make_train_step(jcfg, jprog, jtrain)
    fn = (lambda s, b, k: step(s, b, k)[1]) if metrics_only else step
    params = jtl.cast_params(_jax_init(), jprog.policy.param_dtype)
    return (jax.jit(fn, compiler_options=FAST_COMPILE),
            {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)})


@functools.lru_cache(maxsize=None)
def _reference_step0(precision):
    """The reference at step 0 (B=2, S=32): its init state (numpy), the
    batch, jax.value_and_grad's loss and gradient leaves of loss_fn
    (remat none; each routing call's top-k experts recorded in order),
    and make_train_step's loss and gradient norm (remat block)."""
    cfg, jcfg, _, jprog = _programs(precision)
    step, jstate = _jax_train_step(precision, precision != "fp32")
    batch = SyntheticLM(cfg, ShapeConfig("t", S0, B0, "train")).batch_at(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jsh = JContext(None, jprog, backend="reference")
    record, route = [], jmoe._route

    def recorded(x, w, k):
        v, i, a = route(x, w, k)
        jax.debug.callback(lambda ii: record.append(np.asarray(ii)), i,
                           ordered=True)
        return v, i, a

    jmoe._route = recorded
    try:
        lj, gj = jax.jit(jax.value_and_grad(lambda p: jtfm.loss_fn(
            jcfg, p, jbatch, jsh, compute_dtype=jprog.policy.ff_dtype,
            remat="none")), compiler_options=FAST_COMPILE)(jstate["params"])
        jax.effects_barrier()
    finally:
        jmoe._route = route
    out = step(jstate, jbatch, KEY)
    jmet = out[1] if precision == "fp32" else out
    return (jax.tree.map(np.asarray, jstate), batch, float(lj),
            flat(jax.tree.map(np.asarray, gj)),
            {k: float(v) for k, v in jmet.items()}, tuple(record))


def _held_routes(monkeypatch, experts) -> list:
    """Patches the port's _route to take each call's top-k experts from
    `experts` in call order (the combine weights and aux from its own
    probabilities at them); returns, per call, (tokens whose own top-k
    set differs, tokens).  Every selection must be taken."""
    turns, flips, route = iter(experts), [], moe._route

    def held(x, router_w, top_k, sh):
        fixed = torch.from_numpy(np.array(next(turns))).to(torch.int64)
        own = route(x, router_w, top_k, sh)[1]
        flips.append((int((own.sort(-1)[0] != fixed.sort(-1)[0]).any(-1)
                          .sum()), fixed.shape[0]))
        return route(x, router_w, top_k, sh, experts=fixed)

    monkeypatch.setattr(moe, "_route", held)
    return flips


def _reference_bits(seen):
    """The port's UP entropy hook fed the reference's SR bits for the
    port's own dY: a 2-D weight's make_rbits(up_key(op_key(KEY, op),
    dY)); an expert table's per expert, from op_key split over them."""
    def bits(word, dyt, shape, key, entropy):
        seen.append(word.op)
        lo = word.update_rounding == "sr_lo"
        k = jop_key(KEY, word.op)
        jd = jnp.asarray(to_np(dyt)).astype(jnp.bfloat16)
        if len(shape) == 3:
            keys = jax.random.split(k, shape[0])
            out = np.stack([np.asarray(jops.make_rbits(
                jup_key(keys[e], jd[e]), shape[1:], lo=lo))
                for e in range(shape[0])])
        else:
            out = np.asarray(jops.make_rbits(jup_key(k, jd), shape, lo=lo))
        return torch.from_numpy(out.view(np.int32).copy())
    return bits


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("precision", ["fp32", "paper_sr_bf16"])
def test_loss_and_grads_at_step_0_match_the_reference(precision, backend,
                                                      monkeypatch):
    """loss_fn and every gradient leaf against jax.value_and_grad of the
    reference's, the port held to JAX's expert selection; then the
    step's loss and gradient norm (remat block: each MoE unit routes in
    the forward and again in the recompute) against the reference's
    make_train_step.  Under paper_sr_bf16 the cuda backend's UP rounds
    with the reference's SR bits for its own dY."""
    cfg, _, prog, _ = _programs(precision)
    state0, batch, lj, gjf, jmet, record = _reference_step0(precision)
    n_moe = sum(u.ffn == "moe" for u in tfm.layer_pattern(cfg))
    assert len(record) == n_moe == 4
    seen = []
    if precision == "paper_sr_bf16" and backend == "cuda":
        monkeypatch.setattr(dispatch, "_up_rbits", _reference_bits(seen))
    flips = _held_routes(monkeypatch, record)
    state = state_from_numpy(state0)
    leaves = flat(state["params"])
    for p in leaves.values():
        p.requires_grad_()
    sh = PEContext(prog, backend=backend, phase=Phase.FF)
    loss = tfm.loss_fn(cfg, state["params"], {k: torch.from_numpy(v)
                                              for k, v in batch.items()},
                       sh, compute_dtype=prog.policy.ff_dtype, remat="none")
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    loss_tol, grad_tol, gnorm_tol = STEP0_TOL[precision]
    assert abs(float(loss.detach()) / lj - 1) <= loss_tol
    assert gjf.keys() == grads.keys()
    for path, g in grads.items():
        assert g.dtype == leaves[path].dtype, path
        assert rel(g, gjf[path]) <= grad_tol, (path, rel(g, gjf[path]))
    n_tok = sum(t for _, t in flips)
    assert sum(n for n, _ in flips) <= (
        0 if precision == "fp32" else n_tok // 8), flips
    if seen:
        # every weight word's UP once: attention qkv and o, 7 Mamba
        # mixers' in, xproj, dt and out, 4 dense FFs' in and out, 4 MoE
        # units' three expert tables, and the head
        assert len(seen) == 2 + 4 * 7 + 2 * 4 + 3 * 4 + 1, seen
    monkeypatch.undo()
    if seen:
        monkeypatch.setattr(dispatch, "_up_rbits", _reference_bits([]))
    _held_routes(monkeypatch, record + record)
    step_fn, _ = tl.make_train_step(cfg, prog, TrainConfig(
        precision=precision, remat="block", kernel_backend=backend))
    _, met = step_fn(state_from_numpy(state0), batch, 0)
    assert abs(float(met["loss"]) / jmet["loss"] - 1) <= loss_tol
    assert abs(float(met["grad_norm"]) / jmet["grad_norm"] - 1) <= gnorm_tol


N_STEPS = 6
# a router's k-th and (k+1)-th probabilities nearer than this may order
# differently in the two packages (tests/test_torch_moe.py's TIE_GAP)
TIE_GAP = 1e-5


@pytest.fixture(scope="module")
def fp32_run():
    """The reference's jitted make_train_step: fp32 adamw steps (lr 3e-3,
    remat block) from its own init state, on SyntheticLM batches."""
    cfg, _, prog, _ = _programs("fp32")
    step, state = _jax_train_step("fp32", False)
    state0 = jax.tree.map(np.asarray, state)
    pipe = SyntheticLM(cfg, ShapeConfig("t", S0, B0, "train"))
    losses = []
    for s in range(N_STEPS):
        state, met = step(state, {k: jnp.asarray(v) for k, v in
                                  pipe.batch_at(s).items()},
                          jax.random.fold_in(jax.random.PRNGKey(0), s))
        losses.append(float(met["loss"]))
    return cfg, prog, state0, pipe, np.array(losses)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_fp32_steps_track_the_reference(fp32_run, backend, monkeypatch):
    """From the same converted TrainState and batches, the port's per-step
    losses (the aux term included) stay within rtol 1e-4 of the
    reference's (measured on the CPU: <= 2.5e-7 on both backends, the
    loss falling from 5.587 to 5.12); routing is free, and at every step
    every token-layer's top-k gap (forward and remat recompute) clears
    TIE_GAP."""
    cfg, prog, state0, pipe, want = fp32_run
    gaps, route = [], moe._route

    def spy(x, router_w, top_k, sh):
        with torch.no_grad():
            p = torch.softmax(x.detach().double()
                              @ router_w.detach().double(), dim=-1)
            top = p.sort(dim=-1, descending=True)[0][:, :top_k + 1]
            gaps.append(float((top[:, :-1] - top[:, 1:]).min()))
        return route(x, router_w, top_k, sh)

    monkeypatch.setattr(moe, "_route", spy)
    train = TrainConfig(optimizer="adamw", lr=3e-3, precision="fp32",
                        remat="block", kernel_backend=backend)
    step_fn, _ = tl.make_train_step(cfg, prog, train)
    state = state_from_numpy(state0)
    got = []
    for s in range(N_STEPS):
        state, met = step_fn(state, pipe.batch_at(s), s)
        got.append(float(met["loss"]))
    assert state["step"] == N_STEPS
    assert len(gaps) == 2 * 4 * N_STEPS and min(gaps) > TIE_GAP, min(gaps)
    assert want[-1] < want[0]
    np.testing.assert_allclose(np.array(got), want, rtol=1e-4)


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,precision", [("cuda", "paper_sr_bf16"),
                                               ("reference", "fp32")])
def test_remat_block_gives_the_same_bits_as_none(backend, precision):
    """remat block runs the period under checkpoint: the scan's Function
    runs forward twice and backward once, the routing recomputes the same
    top-k; the loss and every gradient are bit-equal to remat none."""
    cfg = _configs()[0]
    prog = compile_program(cfg, ShapeConfig("t", 24, 2, "train"),
                           precision=precision)
    params = tl.cast_params(tfm.init(torch.Generator().manual_seed(4), cfg),
                            prog.policy.param_dtype)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg, ShapeConfig("t", 24, 2, "train")).batch_at(1).items()}
    sh = PEContext(prog, backend=backend, phase=Phase.FF).with_key(5)
    out = {}
    for remat in ("none", "block"):
        req = {k: v.detach().requires_grad_()
               for k, v in flat(params).items()}
        tree: dict = {}
        for path, t in req.items():
            node = tree
            *head, last = path.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = t
        loss = tfm.loss_fn(cfg, tree, batch, sh,
                           compute_dtype=prog.policy.ff_dtype, remat=remat)
        out[remat] = (loss.detach(),
                      torch.autograd.grad(loss, list(req.values())))
    assert torch.equal(out["block"][0], out["none"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["block"][1],
                                                 out["none"][1]))


def test_state_shapes_of_the_full_model_match_the_reference():
    """The whole paper_sr_bf16 adamw state of jamba-v0.1-52b (32 layers)
    as meta tensors, leaf for leaf the reference's eval_shape, nothing
    allocated."""
    cfg = get_config(JAMBA)
    prog = compile_program(cfg, ShapeConfig("t", 256, 4, "train"))
    ours = tl.state_shapes(cfg, prog, TrainConfig())
    jprog = jcompile(jget_config(JAMBA), JShape("t", 256, 4, "train"), MESH1)
    theirs = jtl.state_shapes(jget_config(JAMBA), jprog, JTrain())
    for name in ("params", "opt"):
        a, b = flat(ours[name]), flat(theirs[name])
        assert a.keys() == b.keys(), name
        for path, t in a.items():
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(b[path].shape), path
            assert str(t.dtype).split(".")[-1] == str(b[path].dtype), path


def test_one_card_train_config_cuts_jamba_and_leaves_the_others_whole():
    """On an 80 GB card under paper_sr_bf16 with adamw: jamba-v0.1-52b to
    one period and 4 of its 16 experts (top-2 kept; 4.84 B parameters,
    whose params, gradients and two bf16 moments, 8 bytes a parameter,
    fit half the card, where 8 experts' would not); every product keeps
    its published width; the models that fit stay whole, under fp32
    too."""
    card = 80 * 10 ** 9
    full = get_config(JAMBA)
    cut = launch_train.one_card_train_config(full, card)
    assert (cut.n_layers, cut.moe.n_experts, cut.moe.top_k) == (8, 4, 2)
    assert cut.param_count() == 4_839_260_160
    size = launch_train.train_state_bytes(cut, TrainConfig())
    assert size <= card // 2
    # every leaf bf16, A_log and D among them: 8 bytes a parameter (the
    # leaves hold 0.0001% more values than param_count counts)
    assert size / cut.param_count() == pytest.approx(8, rel=1e-5)
    wider = dataclasses.replace(cut, moe=dataclasses.replace(cut.moe,
                                                             n_experts=8))
    assert launch_train.train_state_bytes(wider, TrainConfig()) > card // 2
    assert dataclasses.replace(cut, n_layers=32, moe=full.moe) == full
    for arch in ("qwen2-0.5b", "rwkv6-1.6b", "granite-moe-1b-a400m"):
        for precision in ("paper_sr_bf16", "fp32"):
            assert launch_train.one_card_train_config(
                get_config(arch), card,
                TrainConfig(precision=precision)) == get_config(arch)


def test_one_card_train_config_sizes_the_cut_from_the_state_it_allocates():
    """The cut follows the precision and the optimizer: jamba under fp32
    with adamw holds 16 bytes a parameter (f32 params, gradients and two
    moments), so on a 160 GB card it is cut to 4 experts, and on an 80 GB
    card even 2 experts (54.9 GB) are over half of it, which raises
    rather than running out of memory; sgdm holds one moment (12 bytes),
    and microbatches sum the gradients in f32 (10 bytes under
    paper_sr_bf16)."""
    full = get_config(JAMBA)
    f32 = TrainConfig(precision="fp32")
    cut = launch_train.one_card_train_config(full, 160 * 10 ** 9, f32)
    assert (cut.n_layers, cut.moe.n_experts, cut.moe.top_k) == (8, 4, 2)
    per_param = lambda tc: launch_train.train_state_bytes(cut, tc) \
        / cut.param_count()
    assert per_param(f32) == pytest.approx(16, rel=1e-5)
    with pytest.raises(ValueError, match="fp32 with adamw.*2 experts"):
        launch_train.one_card_train_config(full, 80 * 10 ** 9, f32)
    sgdm = TrainConfig(precision="fp32", optimizer="sgdm")
    assert per_param(sgdm) == pytest.approx(12, rel=1e-5)
    assert per_param(TrainConfig(microbatch=2)) == pytest.approx(10, rel=1e-5)


def test_train_cli_trains_jamba_on_the_cpu_and_the_loss_falls(tmp_path,
                                                             capsys):
    """The reduced jamba (16 layers) through launch.train on the cuda
    backend's plain versions: no cut on the CPU, the loss falls, and
    ``--ckpt-every 0`` writes no checkpoint."""
    ckpt_dir = tmp_path / "ckpt"
    args = launch_train.parser().parse_args([
        "--arch", JAMBA, "--reduced", "--device", "cpu", "--kernel-backend",
        "cuda", "--steps", "6", "--batch", "2", "--seq", "32", "--lr",
        "3e-3", "--log-every", "2", "--ckpt-every", "0", "--ckpt-dir",
        str(ckpt_dir)])
    res = launch_train.run(args)
    out = capsys.readouterr().out
    assert f"arch={JAMBA} layers=16" in out and "done: 6 steps; loss" in out
    assert "cut to fit" not in out and res["cfg"] == get_reduced(JAMBA)
    assert not ckpt_dir.exists()
    assert np.all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]
