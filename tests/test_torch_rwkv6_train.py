"""The port's rwkv6 training slice against the JAX package, on the CPU.

The reduced rwkv6 (2 layers, d 128, head_dim 32, d_ff 256, vocab 256) is
built on the JAX side from the port's fields.  Inputs are numpy from a
seed, or the reference's own parameters and TrainState carried across.
The cuda backend's kernels run their plain versions here (CPU tensors).

- ``wkv6_bwd_plain`` (the written-out reverse recurrence) against
  ``jax.vjp`` of the reference's ``wkv6_scan`` (S = 128 crosses its
  64-token re-materialised chunks) and against torch autograd through
  ``wkv6_plain``, at hd 16 and 32, S 1 / 33 / 128, f32 and bf16 r, k, v,
  moderate and near-total decay;
- ``wkv6_train`` (the autograd Function) returning the plain backward's
  results in r's dtype, and refusing a carried state;
- ``rwkv_block``'s gradients against ``jax.grad`` of the reference's;
- the slice: step-0 loss and every gradient leaf against the reference
  under ``fp32`` and ``paper_sr_bf16`` (the cuda backend's UP fed the
  reference's SR bits for its own dY), the step's loss and gradient norm
  against the reference's ``make_train_step``, then 10 ``fp32`` steps;
- remat ``none`` / ``block`` / ``full`` bit-equal, the full-width state
  shapes against the reference's ``eval_shape`` with nothing allocated,
  and the CLI.

Tolerances, each about 5x or more above the gap measured on the CPU
(noted beside it): every comparison is the largest |difference| of an
output over the largest |value| of the reference's output.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.core.dataflow import MeshSpec  # noqa: E402
from repro.core.program import compile_program as jcompile  # noqa: E402
from repro.engine import PEContext as JContext  # noqa: E402
from repro.engine import op_key as jop_key  # noqa: E402
from repro.engine import up_key as jup_key  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
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
from repro_torch.kernels import wkv6 as kwkv  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import train_loop as tl  # noqa: E402

ARCH = "rwkv6-1.6b"
MESH1 = MeshSpec(axis_sizes={"data": 1, "model": 1}, batch_axes=("data",))
KEY = jax.random.PRNGKey(7)
GRADS = ("dr", "dk", "dv", "dw", "du")
# wkv6_bwd_plain against JAX's vjp and torch autograd, f32 results: f32
# recurrences in another order (measured <= 5.6e-7)
BWD_F32_REL = 5e-6
# bf16 r, k, v: JAX rounds dr, dk, dv to bf16 (half a bf16 ulp, 2^-8 of
# the value; measured <= 3.3e-3 of the largest); dw, du stay f32
BWD_BF16_REL = 2e-2
# rwkv_block: f32 (measured <= 6.5e-7: the decay's transcendentals run in
# f64 here, in f32 there), bf16 (measured <= 1.3e-2: bf16 activations
# and gradients rounded at other places)
BLOCK_F32_REL, BLOCK_BF16_REL = 1e-5, 6.5e-2
# step 0, (loss, each gradient leaf, gradient norm): fp32 (measured 0,
# <= 2.5e-6, 0); paper_sr_bf16 (measured <= 2.0e-5, <= 2.1e-2 — the cuda
# backend's SR dW against the reference's nearest, bf16 chains rounded
# at other places — and <= 1.9e-3)
STEP0_TOL = {"fp32": (1e-6, 2e-5, 1e-6),
             "paper_sr_bf16": (2e-4, 0.105, 1e-2)}


def jax_reduced():
    """The reference's rwkv6 config with the port's reduced fields."""
    ours = get_reduced(ARCH)
    full = jget_config(ARCH)
    return dataclasses.replace(
        full, n_layers=ours.n_layers, d_model=ours.d_model, d_ff=ours.d_ff,
        vocab_size=ours.vocab_size, max_seq_len=ours.max_seq_len,
        ssm=dataclasses.replace(full.ssm, head_dim=ours.ssm.head_dim))


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


def wkv_case(S, hd, dtype, decay, B=2, H=2, seed=0):
    """JAX and torch copies of r, k, v (in `dtype`), w, u and dy."""
    rng = np.random.default_rng(seed + S + hd)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(3))
    w = (np.full((B, S, H, hd), decay) if decay is not None
         else 0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((B, S, H, hd)))))
    u = 0.1 * rng.standard_normal((H, hd))
    dy = rng.standard_normal((B, S, H, hd))
    jdt = getattr(jnp, dtype)
    j = [jnp.asarray(a, jnp.float32).astype(jdt) for a in (r, k, v)] + [
        jnp.asarray(a, jnp.float32) for a in (w, u, dy)]
    return j, [to_torch(a) for a in j]


WKV_SHAPES = [(1, 16), (33, 32), (128, 16), (128, 32)]
WKV_DECAYS = [None, 1e-6]


@pytest.mark.parametrize("decay", WKV_DECAYS, ids=["moderate", "strong"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,hd", WKV_SHAPES)
def test_wkv6_bwd_plain_matches_jax_vjp(S, hd, dtype, decay):
    (jr, jk, jv, jw, ju, jdy), args = wkv_case(S, hd, dtype, decay)
    _, vjp = jax.vjp(lambda *a: jssm.wkv6_scan(*a)[0], jr, jk, jv, jw, ju)
    want = vjp(jdy)
    got = kwkv.wkv6_bwd_plain(*args)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        tol = BWD_F32_REL if w.dtype == jnp.float32 else BWD_BF16_REL
        assert rel(g, w) <= tol, (name, rel(g, w))


@pytest.mark.parametrize("decay", WKV_DECAYS, ids=["moderate", "strong"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,hd", WKV_SHAPES)
def test_wkv6_bwd_plain_matches_torch_autograd(S, hd, dtype, decay):
    """Autograd through the forward's plain version (f32 leaves holding
    the same values, so every gradient is f32)."""
    _, args = wkv_case(S, hd, dtype, decay, seed=1)
    r, k, v, w, u, dy = args
    leaves = [t.float().requires_grad_() for t in (r, k, v, w, u)]
    y, _ = kwkv.wkv6_plain(*leaves)
    # at S = 1, w reaches only the final state, which y does not read
    want = torch.autograd.grad((y * dy).sum(), leaves, allow_unused=True)
    got = kwkv.wkv6_bwd_plain(*args)
    for name, g, wv, leaf in zip(GRADS, got, want, leaves):
        wv = torch.zeros_like(leaf) if wv is None else wv
        if not wv.any():
            assert not g.any(), name
            continue
        assert rel(g, wv) <= BWD_F32_REL, (name, rel(g, wv))


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_train_returns_the_plain_gradients_in_the_inputs_dtypes(
        dtype, plain):
    _, (r, k, v, w, u, dy) = wkv_case(9, 16, dtype, None, seed=3)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    kwkv.BWD_COUNTER.reset()
    y = kwkv.wkv6_train(*leaves, plain=plain)
    assert torch.equal(y, kwkv.wkv6_plain(r, k, v, w, u)[0])
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    assert kwkv.BWD_COUNTER.n == 0            # no launch on CPU tensors
    want = kwkv.wkv6_bwd_plain(r, k, v, w, u, dy)
    for g, leaf, wv in zip(grads, leaves, want):
        assert g.dtype == leaf.dtype
        assert torch.equal(g, wv.to(leaf.dtype))


def test_wkv6_train_refuses_a_carried_state():
    _, (r, k, v, w, u, _) = wkv_case(4, 16, "float32", None)
    state = torch.zeros((2, 2, 16, 16), requires_grad=True)
    with pytest.raises(ValueError, match="carried state"):
        kwkv.wkv6_train(r, k, v, w, u, state)


def test_wkv6_bwd_checks_its_operands():
    _, (r, k, v, w, u, dy) = wkv_case(4, 16, "float32", None)
    with pytest.raises(TypeError, match="dy"):
        kwkv.wkv6_bwd(r, k, v, w, u, dy.double())
    with pytest.raises(TypeError, match="contiguous"):
        kwkv.wkv6_bwd(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                      w, u, dy)
    with pytest.raises(ValueError, match="u"):
        kwkv.wkv6_bwd(r, k, v, w, u[None].expand(2, 2, 16).contiguous(), dy)


@pytest.mark.parametrize("B,H,S", [(1, 1, 1), (4, 32, 256), (3, 7, 9),
                                   (1, 128, 5), (8, 64, 4096)])
@pytest.mark.parametrize("hd", kwkv.HEAD_DIMS)
def test_wkv6_bwd_plan_covers_a_head_within_one_block(hd, B, H, S):
    """csrc/wkv6_bwd.cu's launch: one block a (b, h) whose threads hold
    the whole hd x hd state between them, four times the previous
    design's (hd / 4)^2 threads, within the card's 1024 threads and 227
    KB of shared memory a block, tiles of BWD_TILE tokens."""
    p = kwkv.wkv6_bwd_plan(B, H, S, hd)
    assert p.grid == B * H
    assert p.threads * p.cols == hd * hd
    assert p.threads >= 4 * (hd // 4) ** 2
    assert p.threads <= 1024 and p.threads % 32 == 0
    assert 0 < p.smem <= 232448
    assert p.tile == kwkv.BWD_TILE


def test_wkv6_bwd_ablation_edits_find_the_kernel():
    """launch/ablate_wkv6_bwd.py leaves parts of csrc/wkv6_bwd.cu out by
    editing a copy of its source: every edit's anchor is in the kernel
    once, and every variant differs from the kernel."""
    from repro_torch.kernels import build
    from repro_torch.launch import ablate_wkv6_bwd as ablate
    src = (build.CSRC / "wkv6_bwd.cu").read_text()
    for name, edits in ablate.VARIANTS.items():
        text = ablate.variant_source(src, edits)
        assert (text == src) == (name == "full"), name
    with pytest.raises(RuntimeError, match="occurs 0 times"):
        ablate.variant_source(src, (("no such line\n", ""),))


# ---------------------------------------------------------------------------
# rwkv_block
# ---------------------------------------------------------------------------


BLOCK_B, BLOCK_S = 2, 40


@functools.lru_cache(maxsize=None)
def _reference_block_grads(dtype):
    """(x, params, c, dx, dparams) of the reference's rwkv_block: the
    gradients of sum(out * c), from no state, in `dtype`."""
    jcfg = jax_reduced()
    d = jcfg.d_model
    rng = np.random.default_rng(5)
    p = {k: np.array(v) for k, v in jssm.rwkv_params(
        jcfg, jax.random.PRNGKey(2)).items()}
    p["w0"] = (-2 + 0.5 * rng.standard_normal(d)).astype(np.float32)
    p["mix"] = rng.uniform(0, 1, (5, d)).astype(np.float32)
    x = rng.standard_normal((BLOCK_B, BLOCK_S, d)).astype(np.float32)
    c = rng.standard_normal((BLOCK_B, BLOCK_S, d)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p)
    jx = jnp.asarray(x).astype(jdt)

    def jloss(xx, pp):
        out, _ = jssm.rwkv_block(jcfg, xx, pp, Sharder())
        return jnp.sum(out.astype(jnp.float32) * c)

    jgx, jgp = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jx, jp)
    return jx, jp, c, jgx, jgp


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_block_grads_match_jax(dtype, backend):
    """Gradients of sum(out * c) with respect to x and every mixer leaf,
    from no state: the port's words (fp32 or bf16_nearest) against the
    reference's plain dots in x's dtype."""
    cfg = get_reduced(ARCH)
    B, S = BLOCK_B, BLOCK_S
    jx, jp, c, jgx, jgp = _reference_block_grads(dtype)
    prog = compile_program(cfg, ShapeConfig("t", S, B, "train"),
                           precision="fp32" if dtype == "float32"
                           else "bf16_nearest")
    sh = PEContext(prog, backend=backend, phase=Phase.FF)
    tp = {k: to_torch(v).requires_grad_() for k, v in jp.items()}
    tx = to_torch(jx).requires_grad_()
    out = ssm.rwkv_block(cfg, tx, tp, sh)
    assert out.dtype == tx.dtype
    grads = torch.autograd.grad(
        (out.float() * torch.from_numpy(c)).sum(), [tx, *tp.values()])
    tol = BLOCK_F32_REL if dtype == "float32" else BLOCK_BF16_REL
    for name, g, want in zip(["x", *tp], grads, [jgx, *jgp.values()]):
        assert g.dtype == tx.dtype, name
        assert rel(g, want) <= tol, (name, rel(g, want))


# ---------------------------------------------------------------------------
# The slice
# ---------------------------------------------------------------------------


def _programs(precision, seq=32, batch=2):
    cfg, jcfg = get_reduced(ARCH), jax_reduced()
    prog = compile_program(cfg, ShapeConfig("t", seq, batch, "train"),
                           precision=precision)
    jprog = jcompile(jcfg, JShape("t", seq, batch, "train"), MESH1,
                     precision=precision)
    return cfg, jcfg, prog, jprog


@functools.lru_cache(maxsize=None)
def _reference_step0(precision):
    """The reference at step 0 (remat block, B=2, S=32): its init state
    (numpy), the batch, jax.grad's loss and gradient leaves of loss_fn,
    and make_train_step's loss and gradient norm."""
    cfg, jcfg, _, jprog = _programs(precision)
    jtrain = JTrain(precision=precision, remat="block")
    jstep, jopt = jtl.make_train_step(jcfg, jprog, jtrain)
    jstate = jtl.init_state(jcfg, jprog, jtrain, jax.random.PRNGKey(0), jopt)
    batch = SyntheticLM(cfg, ShapeConfig("t", 32, 2, "train")).batch_at(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jsh = JContext(None, jprog, backend="reference")
    lj, gj = jax.jit(jax.value_and_grad(lambda p: jtfm.loss_fn(
        jcfg, p, jbatch, jsh, compute_dtype=jprog.policy.ff_dtype,
        remat="block")))(jstate["params"])
    _, jmet = jax.jit(jstep)(jstate, jbatch, KEY)
    return (jax.tree.map(np.asarray, jstate), batch, float(lj),
            flat(jax.tree.map(np.asarray, gj)),
            {k: float(v) for k, v in jmet.items()})


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("precision", ["fp32", "paper_sr_bf16"])
def test_loss_and_grads_at_step_0_match_the_reference(precision, backend,
                                                      monkeypatch):
    """loss_fn (remat block) and every gradient leaf against jax.grad of
    the reference's; then the step's loss and gradient norm against the
    reference's make_train_step.  Under paper_sr_bf16 the cuda backend's
    UP rounds with the reference's SR bits for its own dY."""
    cfg, _, prog, _ = _programs(precision)
    state0, batch, lj, gjf, jmet = _reference_step0(precision)
    if precision == "paper_sr_bf16" and backend == "cuda":
        seen = []

        def reference_bits(word, dyt, shape, key, entropy):
            seen.append(word.op)
            jd = jnp.asarray(to_np(dyt)).astype(jnp.bfloat16)
            bits = jops.make_rbits(jup_key(jop_key(KEY, word.op), jd), shape)
            return torch.from_numpy(
                np.asarray(bits).view(np.int32).copy())

        monkeypatch.setattr(dispatch, "_up_rbits", reference_bits)
    state = state_from_numpy(state0)
    leaves = flat(state["params"])
    for p in leaves.values():
        p.requires_grad_()
    sh = PEContext(prog, backend=backend, phase=Phase.FF)
    loss = tfm.loss_fn(cfg, state["params"], {k: torch.from_numpy(v)
                                              for k, v in batch.items()},
                       sh, compute_dtype=prog.policy.ff_dtype, remat="block")
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    loss_tol, grad_tol, gnorm_tol = STEP0_TOL[precision]
    assert abs(float(loss.detach()) / lj - 1) <= loss_tol
    assert gjf.keys() == grads.keys()
    for path, g in grads.items():
        assert g.dtype == leaves[path].dtype, path
        assert rel(g, gjf[path]) <= grad_tol, (path, rel(g, gjf[path]))
    if precision == "paper_sr_bf16" and backend == "cuda":
        # every weight word's UP: 4 rkvg quarters, decay, o, ffn_in, ffn_out
        # a layer, and the head
        assert len(seen) == 8 * cfg.n_layers + 1, seen
        monkeypatch.undo()
    step_fn, _ = tl.make_train_step(cfg, prog, TrainConfig(
        precision=precision, remat="block", kernel_backend=backend))
    _, met = step_fn(state_from_numpy(state0), batch, 0)
    assert abs(float(met["loss"]) / jmet["loss"] - 1) <= loss_tol
    assert abs(float(met["grad_norm"]) / jmet["grad_norm"] - 1) <= gnorm_tol


N_STEPS = 10


@pytest.fixture(scope="module")
def fp32_run():
    """The reference's jitted make_train_step: 10 fp32 adamw steps with
    remat 'block' from its own init state, on SyntheticLM batches."""
    cfg, jcfg, prog, jprog = _programs("fp32", seq=32, batch=4)
    jtrain = JTrain(optimizer="adamw", lr=3e-3, precision="fp32",
                    remat="block")
    step_fn, opt = jtl.make_train_step(jcfg, jprog, jtrain)
    jstep = jax.jit(step_fn)
    state = jtl.init_state(jcfg, jprog, jtrain, jax.random.PRNGKey(0), opt)
    state0 = jax.tree.map(np.asarray, state)
    pipe = SyntheticLM(cfg, ShapeConfig("t", 32, 4, "train"))
    losses = []
    for s in range(N_STEPS):
        state, met = jstep(state, {k: jnp.asarray(v) for k, v in
                                   pipe.batch_at(s).items()},
                           jax.random.fold_in(jax.random.PRNGKey(0), s))
        losses.append(float(met["loss"]))
    return cfg, prog, state0, pipe, np.array(losses)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_ten_fp32_steps_track_the_reference(fp32_run, backend):
    """From the same converted TrainState and batches, the port's per-step
    losses stay within rtol 1e-3 of the reference's (measured on the
    CPU: 8.9e-7 on the reference backend, 1.9e-7 on the cuda backend,
    the loss falling from 5.517 to 4.832)."""
    cfg, prog, state0, pipe, want = fp32_run
    train = TrainConfig(optimizer="adamw", lr=3e-3, precision="fp32",
                        remat="block", kernel_backend=backend)
    step_fn, _ = tl.make_train_step(cfg, prog, train)
    state = state_from_numpy(state0)
    got = []
    for s in range(N_STEPS):
        state, met = step_fn(state, pipe.batch_at(s), s)
        got.append(float(met["loss"]))
    assert state["step"] == N_STEPS
    assert want[-1] < want[0]
    np.testing.assert_allclose(np.array(got), want, rtol=1e-3)


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,precision", [("cuda", "paper_sr_bf16"),
                                               ("reference", "fp32")])
def test_remat_modes_give_the_same_bits(backend, precision):
    cfg = get_reduced(ARCH)
    prog = compile_program(cfg, ShapeConfig("t", 24, 2, "train"),
                           precision=precision)
    params = tl.cast_params(tfm.init(torch.Generator().manual_seed(4), cfg),
                            prog.policy.param_dtype)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg, ShapeConfig("t", 24, 2, "train")).batch_at(1).items()}
    sh = PEContext(prog, backend=backend, phase=Phase.FF).with_key(5)
    out = {}
    for remat in ("none", "block", "full"):
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
    for remat in ("block", "full"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1],
                                                     out["none"][1])), remat


def test_state_shapes_at_full_width_match_the_reference():
    """The whole paper_sr_bf16 adamw state of rwkv6-1.6b as meta tensors,
    leaf for leaf the reference's eval_shape, nothing allocated."""
    cfg = get_config(ARCH)
    shape = ShapeConfig("t", 256, 4, "train")
    prog = compile_program(cfg, shape)
    ours = tl.state_shapes(cfg, prog, TrainConfig())
    jprog = jcompile(jget_config(ARCH), JShape("t", 256, 4, "train"), MESH1)
    theirs = jtl.state_shapes(jget_config(ARCH), jprog, JTrain())
    for name in ("params", "opt"):
        a, b = flat(ours[name]), flat(jax.tree.map(lambda s: s, theirs[name]))
        assert a.keys() == b.keys(), name
        for path, t in a.items():
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(b[path].shape), path
            assert str(t.dtype).split(".")[-1] == str(b[path].dtype), path


def test_train_cli_trains_rwkv6_on_the_cpu_and_the_loss_falls(tmp_path,
                                                             capsys):
    args = launch_train.parser().parse_args([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--kernel-backend",
        "cuda", "--steps", "8", "--batch", "4", "--seq", "32", "--lr",
        "3e-3", "--log-every", "2", "--ckpt-dir", str(tmp_path)])
    res = launch_train.run(args)
    out = capsys.readouterr().out
    assert f"arch={ARCH} layers=2" in out and "done: 8 steps; loss" in out
    assert np.all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]
