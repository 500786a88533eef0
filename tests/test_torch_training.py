"""The port's training slice against the JAX package, on the CPU.

Same inputs (numpy from a seed, or the reference's own ``tfm.init``
parameters and ``TrainState`` carried across by bit pattern) go through
both packages at the reduced qwen2-0.5b size (2 layers, d 64):

- the FF / BP / UP words of ``pe_dot``: dX and dW against the JAX
  ``pallas`` backend (interpret mode), SR dW with the JAX entropy
  injected, and UP reaching ``outer_accum`` only on the cuda backend;
- SR rounding (full and the sliding-window LO stream) and every
  optimizer's per-leaf writeback, bit-equal given the same bits;
- ``SyntheticLM`` batches and ``split_microbatches``, bit-equal;
- the slice: ``loss_fn`` value and grads at step 0 on both port
  backends, then 10 fp32 adamw steps with remat against the reference's
  ``make_train_step``;
- microbatching, checkpoint / restart and the CLI on the port alone.

The cuda backend's kernels run their plain versions here (CPU tensors).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.core import rounding as jrounding  # noqa: E402
from repro.core.dataflow import MeshSpec  # noqa: E402
from repro.core.precision import get_policy as jget_policy  # noqa: E402
from repro.core.program import PEWord as JWord  # noqa: E402
from repro.core.program import compile_program as jcompile  # noqa: E402
from repro.data.pipeline import PipelineConfig as JPipeCfg  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynth  # noqa: E402
from repro.engine import PEContext as JContext  # noqa: E402
from repro.engine import pe_dot as jpe_dot  # noqa: E402
from repro.engine import up_key as jup_key  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint.convert import (params_from_numpy,  # noqa: E402
                                            state_from_numpy)
from repro_torch.configs import TrainConfig, get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import rounding  # noqa: E402
from repro_torch.core.phases import Phase  # noqa: E402
from repro_torch.core.precision import get_policy  # noqa: E402
from repro_torch.core.program import PEWord, compile_program  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.engine import PEContext, pe_dot  # noqa: E402
from repro_torch.kernels import outer_accum as koa  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim import optimizers as optim_mod  # noqa: E402
from repro_torch.runtime import train_loop as tl  # noqa: E402
from repro_torch.runtime.fault_tolerance import run_with_recovery  # noqa: E402

ARCH = "qwen2-0.5b"
MESH1 = MeshSpec(axis_sizes={"data": 1, "model": 1}, batch_axes=("data",))
KEY = jax.random.PRNGKey(7)
# bf16 ulp is 2^-8 of magnitude; f32 accumulation in another order may
# move a value across one rounding boundary (tests/test_engine.py:33)
BF16_TOL = dict(rtol=2e-2, atol=2e-3)


def bf16_pair(x: np.ndarray):
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    bits = np.asarray(jax.lax.bitcast_convert_type(j, jnp.uint16))
    return j, torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bits16(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint16))


def flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def i32(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, np.uint32).view(np.int32).copy())


# ---------------------------------------------------------------------------
# pe_dot: the FF / BP / UP word
# ---------------------------------------------------------------------------


def _port_grads(word, backend, x, w, transpose_w=False, entropy=None):
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_()
    y = pe_dot(x, w, word=word, backend=backend, transpose_w=transpose_w,
               phase=Phase.FF, entropy=entropy)
    loss = torch.sum(y.to(torch.float32) ** 2)
    return y.detach(), torch.autograd.grad(loss, (x, w))


def _jax_grads(word, x, w, transpose_w=False):
    def loss(x, w):
        y = jpe_dot(x, w, word=word, backend="pallas", key=KEY,
                    transpose_w=transpose_w)
        return jnp.sum(y.astype(jnp.float32) ** 2)
    return jax.grad(loss, argnums=(0, 1))(x, w)


@pytest.mark.parametrize("transpose_w", [False, True])
def test_pe_dot_ff_bp_up_match_pallas(transpose_w):
    rng = np.random.default_rng(0)
    xj, xt = bf16_pair(rng.standard_normal((32, 64)))
    wj, wt = bf16_pair(rng.standard_normal((96, 64) if transpose_w
                                           else (64, 96)))
    jword = JWord(op="w", update_rounding="nearest")
    tword = PEWord(op="w", update_rounding="nearest")
    yj = jpe_dot(xj, wj, word=jword, backend="pallas", key=KEY,
                 transpose_w=transpose_w)
    dxj, dwj = _jax_grads(jword, xj, wj, transpose_w)
    yt, (dxt, dwt) = _port_grads(tword, "cuda", xt, wt, transpose_w)
    assert yt.dtype == dxt.dtype == dwt.dtype == torch.bfloat16
    for got, want in ((yt, yj), (dxt, dxj), (dwt, dwj)):
        np.testing.assert_allclose(to_np(got), to_np(want), **BF16_TOL)


@pytest.mark.parametrize("transpose_w", [False, True])
def test_up_sr_dw_with_the_reference_entropy_injected(transpose_w):
    """The reference's UP bits (make_rbits of up_key(key, dY), the draw
    tests/test_engine.py:90-108 rebuilds) fed to the port's UP word: the
    SR dW agrees bit for bit on all but a few elements, where the f32
    order of dY's own product moved it by a bf16 step."""
    rng = np.random.default_rng(1)
    xj, xt = bf16_pair(rng.standard_normal((64, 48)))
    wj, wt = bf16_pair(rng.standard_normal((32, 48) if transpose_w
                                           else (48, 32)))
    jword = JWord(op="w", update_rounding="sr")
    _, dwj = _jax_grads(jword, xj, wj, transpose_w)
    yj = jpe_dot(xj, wj, word=jword, backend="pallas", key=KEY,
                 transpose_w=transpose_w)
    dy = (2.0 * yj.astype(jnp.float32)).astype(jnp.bfloat16)
    dyt = xj if transpose_w else dy              # the UP kernel's dY operand
    rb = np.asarray(jops.make_rbits(jup_key(KEY, dyt), dwj.shape))
    seen = []

    def entropy(op, d):
        seen.append((op, tuple(d.shape)))
        return i32(rb)

    _, (_, dwt) = _port_grads(PEWord(op="w", update_rounding="sr"), "cuda",
                              xt, wt, transpose_w, entropy=entropy)
    assert seen == [("w", tuple(dyt.shape))]
    assert dwt.dtype == torch.bfloat16
    exact = np.mean(bits16(dwt) == bits16(dwj))
    assert exact > 0.97, exact
    np.testing.assert_allclose(to_np(dwt), to_np(dwj), rtol=2e-2, atol=1e-4)


def test_up_draws_entropy_per_op_and_gradient():
    """Without a hook the UP bits come from a generator seeded by
    up_key(op_key(step key, op), dY): distinct ops, distinct draws; the
    same (key, op, dY), the same draw."""
    rng = np.random.default_rng(2)
    _, xt = bf16_pair(rng.standard_normal((16, 24)))
    _, wt = bf16_pair(rng.standard_normal((24, 40)))
    prog = compile_program(get_reduced(ARCH),
                           ShapeConfig("t", 16, 1, "train"))
    sh = PEContext(prog, backend="cuda", phase=Phase.FF).with_key(5)

    def dw(op):
        w = wt.clone().requires_grad_()
        return torch.autograd.grad(sh.dot(op, xt, w).float().sum(), w)[0]

    a, b = dw("ffn_in"), dw("ffn_out")
    assert torch.equal(a.view(torch.int16), dw("ffn_in").view(torch.int16))
    assert not torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_up_phase_uses_outer_accum_only_on_the_cuda_backend(monkeypatch):
    calls = []
    real = koa.outer_accum

    def spy(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(koa, "outer_accum", spy)
    rng = np.random.default_rng(3)
    _, xt = bf16_pair(rng.standard_normal((40, 56)))
    _, wt = bf16_pair(rng.standard_normal((56, 40)))
    word = PEWord(op="w", update_rounding="sr")
    _port_grads(word, "cuda", xt, wt)
    assert calls == [(40, 56)]
    _port_grads(word, "reference", xt, wt)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# Rounding and the optimizers' writeback
# ---------------------------------------------------------------------------


def test_sr_full_and_lo_bit_equal_given_the_same_bits():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((37, 53)) * 3).astype(np.float32)
    n = x.size
    key = jax.random.PRNGKey(11)
    full = jax.random.bits(key, x.shape, dtype=jnp.uint32)
    stream = jax.random.bits(key, ((n + 31) // 32 + 1,), dtype=jnp.uint32)
    got = rounding.sr_by_name("sr")(torch.from_numpy(x), rbits=i32(full))
    np.testing.assert_array_equal(
        bits16(got), bits16(jrounding.stochastic_round_bf16(jnp.asarray(x),
                                                            key)))
    got = rounding.sr_by_name("sr_lo")(torch.from_numpy(x),
                                       stream=i32(stream))
    np.testing.assert_array_equal(
        bits16(got),
        bits16(jrounding.stochastic_round_bf16_lo(jnp.asarray(x), key)))
    np.testing.assert_array_equal(
        bits16(rounding.sr_by_name("nearest")(torch.from_numpy(x))),
        bits16(jrounding.sr_by_name("nearest")(jnp.asarray(x))))


@pytest.mark.parametrize("name", ["fp32", "bf16_fp32", "paper_sr_bf16",
                                  "paper_sr_lo_bf16", "bf16_nearest"])
def test_precision_policy_matches_the_reference(name):
    ours, theirs = get_policy(name), jget_policy(name)
    assert ours.bytes_per_param_state == theirs.bytes_per_param_state
    assert ours.update_rounding == theirs.update_rounding
    for phase in (Phase.FF, Phase.BP, Phase.UP):
        x = torch.ones(2, dtype=torch.float32)
        assert str(ours.cast_for(phase, x).dtype).split(".")[-1] == \
            str(jnp.dtype(theirs.compute_dtype(phase)))
    x = np.linspace(-3, 3, 64, dtype=np.float32)
    key = jax.random.PRNGKey(5)
    if theirs.update_rounding == "sr":
        rb = i32(jax.random.bits(key, x.shape, dtype=jnp.uint32))
    elif theirs.update_rounding == "sr_lo":
        stream = i32(jax.random.bits(key, ((x.size + 31) // 32 + 1,),
                                     dtype=jnp.uint32))
        rb = rounding.sliding_window_bits(stream, x.size)
    else:
        rb = None
    got = ours.writeback(torch.from_numpy(x), rbits=rb)
    want = theirs.writeback(jnp.asarray(x), key)
    assert got.dtype == (torch.float32 if name in ("fp32", "bf16_fp32")
                         else torch.bfloat16)
    np.testing.assert_array_equal(to_np(got), to_np(want))
    if got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(bits16(got), bits16(want))


def test_sr_lo_stream_is_not_the_make_rbits_lo_layout():
    """Both LO layouts exist: the sliding window of the optimizer's SR LO
    and the rotated block words of the kernels' fused epilogue."""
    g = torch.Generator().manual_seed(0)
    a = rounding.sr_bits("sr_lo", (4, 64), g)
    g = torch.Generator().manual_seed(0)
    b = rounding.make_rbits((4, 64), g, lo=True) & 0xFFFF
    assert not torch.equal(a, b)
    for mode in ("sr", "sr_lo"):
        r = rounding.sr_bits(mode, (8, 8), torch.Generator().manual_seed(1))
        assert r.dtype == torch.int32 and tuple(r.shape) == (8, 8)


def _jax_leaf_bits(opt_name: str, policy_name: str, key, shape):
    """The bits the reference's per-leaf update draws for a one-leaf tree:
    split(key, 1)[0] then one key per written-back tensor."""
    k = jax.random.split(key, 1)[0]
    n_out = 3 if opt_name == "adamw" else 2
    out = []
    for kk in jax.random.split(k, n_out):
        if policy_name == "paper_sr_lo_bf16":
            n = int(np.prod(shape))
            stream = i32(jax.random.bits(kk, ((n + 31) // 32 + 1,),
                                         dtype=jnp.uint32))
            out.append(rounding.sliding_window_bits(stream, n).reshape(shape))
        else:
            out.append(i32(jax.random.bits(kk, shape, dtype=jnp.uint32)))
    return out


@pytest.mark.parametrize("policy_name", ["paper_sr_bf16", "paper_sr_lo_bf16"])
@pytest.mark.parametrize("opt_name", ["sgdm", "adamw", "adagrad"])
def test_optimizer_leaf_update_bit_equal_to_reference(opt_name, policy_name):
    rng = np.random.default_rng(5)
    shape = (24, 40)
    p = bf16_pair(rng.standard_normal(shape) * 0.05)
    g = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    m = bf16_pair(rng.standard_normal(shape) * 1e-3)
    v = bf16_pair(np.abs(rng.standard_normal(shape)) * 1e-5)
    names = {"sgdm": ("m",), "adamw": ("m", "v"), "adagrad": ("v",)}[opt_name]
    mom = {"m": m, "v": v}
    key = jax.random.PRNGKey(3)
    step = 4
    jopt = joptim.make_optimizer(JTrain(optimizer=opt_name),
                                 jget_policy(policy_name))
    jp, js = jopt.update({"w": jnp.asarray(g)},
                         {n: {"w": mom[n][0]} for n in names},
                         {"w": p[0]}, jnp.asarray(step, jnp.int32), key)
    rbits = _jax_leaf_bits(opt_name, policy_name, key, shape)
    for backend in ("reference", "cuda"):
        opt = make_optimizer(TrainConfig(optimizer=opt_name),
                             get_policy(policy_name), backend)
        out = opt.leaf(torch.from_numpy(g), *(mom[n][1] for n in names),
                       p[1], step, rbits=rbits)
        want = [jp["w"]] + [js[n]["w"] for n in names]
        for o, w in zip(out, want):
            assert o.dtype == torch.bfloat16
            np.testing.assert_array_equal(bits16(o), bits16(w))


# a stacked leaf (updated layer by layer once the threshold is lowered
# below its 7680 f32 bytes) and a 2-D one (always whole), in tree order
CHUNK_SHAPES = {"stack": (6, 8, 40), "w": (24, 40)}
CHUNK_LOW = 1000.0
OPT_NAMES = {"sgdm": ("m",), "adamw": ("m", "v"), "adagrad": ("v",)}


def _chunk_inputs(policy_name: str):
    """(grads, moments, params) as JAX arrays and as port tensors with the
    same values: params and moments at the policy's storage dtypes, the
    gradients bf16-representable (f32 to JAX, as its step casts them;
    bf16 to the port under paper_sr_bf16, as its step passes them)."""
    rng = np.random.default_rng(12)
    bf = policy_name != "fp32"
    out = {"g": ({}, {}), "p": ({}, {}), "m": ({}, {}), "v": ({}, {})}
    for name, shape in CHUNK_SHAPES.items():
        for key, scale in (("p", 0.05), ("g", 1e-2), ("m", 1e-3),
                           ("v", 1e-5)):
            x = rng.standard_normal(shape) * scale
            x = np.abs(x) if key == "v" else x
            j, t = bf16_pair(x)
            if key == "g" or not bf:
                j = j.astype(jnp.float32)
                t = t if (key == "g" and bf) else t.float()
            out[key][0][name], out[key][1][name] = j, t
    return out


@pytest.mark.parametrize("opt_name", list(OPT_NAMES))
def test_chunked_fp32_update_equals_the_whole_leaf_update(opt_name,
                                                          monkeypatch):
    """fp32: the stacked leaf updated layer by layer (the threshold
    lowered) gives the whole-leaf update's bits, for every optimizer."""
    inp = _chunk_inputs("fp32")
    names = OPT_NAMES[opt_name]
    opt = make_optimizer(TrainConfig(optimizer=opt_name), get_policy("fp32"),
                         "cuda")
    args = (inp["g"][1], {n: inp[n][1] for n in names}, inp["p"][1], 4, None)
    stack = inp["p"][1]["stack"]
    assert not optim_mod.chunked(stack)
    whole = opt.update(*args)
    monkeypatch.setattr(optim_mod, "_CHUNK_BYTES", CHUNK_LOW)
    assert optim_mod.chunked(stack) and not optim_mod.chunked(inp["p"][1]["w"])
    chunked = opt.update(*args)
    for a, b in zip(tree_flat(whole), tree_flat(chunked)):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def tree_flat(pair) -> list:
    new_p, new_s = pair
    return list(flat(new_p).values()) + [
        v for n in sorted(new_s) for v in flat(new_s[n]).values()]


def _leafwise_bits(opt_name: str, key, shapes: dict, chunk: set) -> dict:
    """The bits the reference's _leafwise update draws: leaf i's key is
    split(key, n)[i]; a scanned leaf's layer l takes fold_in(that, l),
    then one key per written-back tensor."""
    n_out = 1 + len(OPT_NAMES[opt_name])
    keys = jax.random.split(key, len(shapes))
    bits = {}
    for i, (name, shape) in enumerate(shapes.items()):
        layers = range(shape[0]) if name in chunk else (None,)
        for layer in layers:
            k = keys[i] if layer is None else jax.random.fold_in(keys[i],
                                                                 layer)
            sub = shape if layer is None else shape[1:]
            bits[i, layer] = [i32(jax.random.bits(kk, sub, dtype=jnp.uint32))
                              for kk in jax.random.split(k, n_out)]
    return bits


def _scan_op_by_op(body, carry, xs):
    """jax.lax.scan's semantics, each step's ops dispatched one by one
    (as the reference's unscanned update runs them in these tests)."""
    ys = []
    for j in range(jax.tree.leaves(xs)[0].shape[0]):
        carry, y = body(carry, jax.tree.map(lambda a: a[j], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


@pytest.mark.parametrize("opt_name", list(OPT_NAMES))
def test_chunked_sr_update_matches_the_reference_leafwise_given_its_bits(
        opt_name, monkeypatch):
    """paper_sr_bf16 with the threshold lowered in both packages: the
    port's layer-by-layer update, given the bits that the reference's
    _leafwise scan draws for each layer (and for the whole 2-D leaf),
    writes back the same bf16 bits as the reference, on both backends,
    from bf16 gradients where the reference takes them in f32.

    The reference's scan runs op by op, as its unscanned update does in
    test_optimizer_leaf_update_bit_equal_to_reference: compiled, XLA
    contracts sgdm's momentum * m + g into one fused multiply-add inside
    the scan body, which moves one momentum of these 1920 (0.0 against
    -3.27e-11) and which neither package's unscanned update does."""
    monkeypatch.setattr(joptim, "_CHUNK_BYTES", CHUNK_LOW)
    monkeypatch.setattr(optim_mod, "_CHUNK_BYTES", CHUNK_LOW)
    monkeypatch.setattr(jax.lax, "scan", _scan_op_by_op)
    inp = _chunk_inputs("paper_sr_bf16")
    names = OPT_NAMES[opt_name]
    key, step = jax.random.PRNGKey(21), 3
    jopt = joptim.make_optimizer(JTrain(optimizer=opt_name),
                                 jget_policy("paper_sr_bf16"))
    jp, js = jopt.update(inp["g"][0], {n: inp[n][0] for n in names},
                         inp["p"][0], jnp.asarray(step, jnp.int32), key)
    bits = _leafwise_bits(opt_name, key, CHUNK_SHAPES, {"stack"})
    want = [flat(jp)] + [flat(js[n]) for n in names]
    for backend in ("reference", "cuda"):
        opt = make_optimizer(TrainConfig(optimizer=opt_name),
                             get_policy("paper_sr_bf16"), backend)
        asked = []

        def rbits(i, layer):
            asked.append((i, layer))
            return bits[i, layer]

        new_p, new_s = opt.update(inp["g"][1], {n: inp[n][1] for n in names},
                                  inp["p"][1], step, None, rbits=rbits)
        assert sorted(asked, key=str) == sorted(bits, key=str)
        for got, ref in zip([flat(new_p)] + [flat(new_s[n]) for n in names],
                            want):
            for path, t in got.items():
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(bits16(t), bits16(ref[path]),
                                              err_msg=path)


def test_chunked_sr_update_seeds_each_layer_from_fold_key(monkeypatch):
    """A live step's layout for a layer-by-layer leaf: layer l of leaf i
    draws its written-back tensors' bits from generators seeded with
    fold_key(fold_key(fold_key(key, i), l), j), the counterpart of the
    reference's fold_in(split(key)[i], l)."""
    monkeypatch.setattr(optim_mod, "_CHUNK_BYTES", CHUNK_LOW)
    inp = _chunk_inputs("paper_sr_bf16")
    opt = make_optimizer(TrainConfig(optimizer="adamw"),
                         get_policy("paper_sr_bf16"), "reference")
    key, step = 77, 2
    new_p, new_s = opt.update(inp["g"][1], {n: inp[n][1] for n in "mv"},
                              inp["p"][1], step, key)
    for layer in range(CHUNK_SHAPES["stack"][0]):
        lk = rounding.fold_key(rounding.fold_key(key, 0), layer)
        gens = [torch.Generator().manual_seed(rounding.fold_key(lk, j))
                for j in range(3)]
        want = opt.leaf(*(inp[n][1]["stack"][layer] for n in "gmvp"), step,
                        gens=gens)
        for got, w in zip((new_p, new_s["m"], new_s["v"]), want):
            assert torch.equal(got["stack"][layer].view(torch.int16),
                               w.view(torch.int16))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_lm_batches_equal_the_reference(seed):
    shape = ShapeConfig("t", seq_len=24, global_batch=4, kind="train")
    ours = SyntheticLM(get_reduced(ARCH), shape, PipelineConfig(seed=seed))
    theirs = JSynth(jget_reduced(ARCH), JShape("t", 24, 4, "train"),
                    JPipeCfg(seed=seed))
    for step in (0, 1, 7):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    a = ours.batch_at(2, host_id=1, n_hosts=2)
    b = theirs.batch_at(2, host_id=1, n_hosts=2)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("nm", [2, 4])
def test_split_microbatches_equals_the_reference(nm):
    batch = SyntheticLM(get_reduced(ARCH),
                        ShapeConfig("t", 8, 8, "train")).batch_at(0)
    want = jtl.split_microbatches(batch, nm)
    got = tl.split_microbatches(batch, nm)
    tgot = tl.split_microbatches({k: torch.from_numpy(v)
                                  for k, v in batch.items()}, nm)
    for k in batch:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(tgot[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# Model pieces: attention and the loss head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, None), (True, 300),
                                           (False, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_the_reference(causal, window, dtype):
    """S = 2048 runs two q chunks against two kv chunks of 1024 (the
    online softmax across chunks).  f32: one f32 computation in another
    order (rtol 1e-5 / atol 1e-6); bf16: the bf16 cast of p before PV
    and of the output (BF16_TOL)."""
    rng = np.random.default_rng(12)
    B, S, K, G, hd = 1, 2048, 1, 2, 8
    q, k, v = (rng.standard_normal(s) for s in
               ((B, S, K, G, hd), (B, S, K, hd), (B, S, K, hd)))
    if dtype == "float32":
        jq, jk, jv = (jnp.asarray(a, jnp.float32) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(a.astype(np.float32)) for a in (q, k, v))
        tol = dict(rtol=1e-5, atol=1e-6)
    else:
        (jq, tq), (jk, tk), (jv, tv) = (bf16_pair(a) for a in (q, k, v))
        tol = BF16_TOL
    want = jattn.flash_attention(jq, jk, jv, causal=causal, window=window)
    got = attn.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and tuple(got.shape) == q.shape
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


def test_cross_entropy_and_loss_chunks_match_the_reference():
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((3, 5, 17)).astype(np.float32)
    labels = rng.integers(0, 17, size=(3, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(layers.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels))),
        float(jlayers.cross_entropy(jnp.asarray(logits),
                                    jnp.asarray(labels))), rtol=1e-6)
    # 4 chunks for the full-width step of chip_smoke.py, 1 at the
    # reduced size; a count that does not divide B steps down (8 rows of
    # 128 tokens: round(4.86) = 5 -> 4)
    assert layers.loss_chunks(4, 256, 151936) == 4
    assert layers.loss_chunks(2, 16, 256) == 1
    assert layers.loss_chunks(6, 1024, 151936) == 6
    assert layers.loss_chunks(8, 128, 151936) == 4


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_chunked_loss_matches_the_reference(n_chunks):
    """The strided batch chunks, each under checkpoint, give the
    reference's loss and the same gradients for any chunk count."""
    cfg, jcfg, prog, jprog = _programs("fp32", seq=8, batch=4)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    table = (rng.standard_normal((cfg.vocab_size, cfg.d_model)) * 0.1
             ).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(4, 8)).astype(np.int32)
    jsh = JContext(None, jprog, backend="reference")
    lj, gj = jax.value_and_grad(lambda x, t: jlayers.lm_loss_chunked(
        jcfg, x, {"embed": {"table": t}}, jnp.asarray(labels), jsh,
        n_chunks=n_chunks), argnums=(0, 1))(jnp.asarray(x),
                                            jnp.asarray(table))
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    sh = PEContext(prog, backend="cuda", phase=Phase.FF)
    lt = layers.lm_loss_chunked(cfg, tx, {"embed": {"table": tt}},
                                torch.from_numpy(labels), sh,
                                n_chunks=n_chunks)
    gx, gt = torch.autograd.grad(lt, (tx, tt))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gj[0]), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj[1]), rtol=1e-4,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# The slice
# ---------------------------------------------------------------------------


def _programs(precision, seq=16, batch=2):
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    prog = compile_program(cfg, ShapeConfig("t", seq, batch, "train"),
                           precision=precision)
    jprog = jcompile(jcfg, JShape("t", seq, batch, "train"), MESH1,
                     precision=precision)
    return cfg, jcfg, prog, jprog


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("precision", ["paper_sr_bf16", "fp32"])
def test_loss_and_grads_at_step_0_match_the_reference(precision, backend):
    """paper_sr_bf16: the tolerances of tests/test_engine.py:210-223 (loss
    rtol 1e-4; grads within 5% of each leaf's largest value, which also
    covers SR against nearest dW).  fp32: one f32 forward and backward,
    loss rtol 1e-5 and grads within 1e-4."""
    cfg, jcfg, prog, jprog = _programs(precision)
    policy = prog.policy
    jparams = jtl.cast_params(jtfm.init(jax.random.PRNGKey(0), jcfg),
                              jprog.policy.param_dtype)
    batch = SyntheticLM(cfg, ShapeConfig("t", 16, 2, "train")).batch_at(0)
    jsh = JContext(None, jprog, backend="reference")
    lj, gj = jax.value_and_grad(lambda p: jtfm.loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, jsh,
        compute_dtype=jprog.policy.ff_dtype, remat="none"))(jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    leaves = flat(params)
    for p in leaves.values():
        p.requires_grad_()
    sh = PEContext(prog, backend=backend, phase=Phase.FF)
    loss = tfm.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, sh,
                       compute_dtype=policy.ff_dtype, remat="none")
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    loss_rtol, grad_rel = (1e-4, 0.05) if precision != "fp32" else (1e-5, 1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(lj),
                               rtol=loss_rtol)
    gjf = flat(jax.tree.map(np.asarray, gj))
    assert gjf.keys() == grads.keys()
    for path, g in grads.items():
        assert g.dtype == leaves[path].dtype, path
        r, p = to_np(gjf[path]), to_np(g)
        rel = np.abs(r - p).max() / (np.abs(r).max() + 1e-8)
        assert rel < grad_rel, (path, rel)


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
    losses stay within rtol 1e-3 of the reference's.  Measured on the
    CPU: max relative error 1.84e-07 (reference backend) and 1.80e-07
    (cuda backend, plain kernels) over the 10 steps, the loss falling
    from 5.539 to 4.968."""
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
# Accounting, restart and the CLI (the port alone)
# ---------------------------------------------------------------------------


def _port_state(precision, backend, train_kw=None, seq=16, batch=4):
    cfg = get_reduced(ARCH)
    prog = compile_program(cfg, ShapeConfig("t", seq, batch, "train"),
                           precision=precision)
    train = TrainConfig(precision=precision, kernel_backend=backend,
                        **(train_kw or {}))
    step_fn, opt = tl.make_train_step(cfg, prog, train)
    state = tl.init_state(cfg, prog, train, torch.Generator().manual_seed(0),
                          opt)
    return cfg, step_fn, state, SyntheticLM(cfg, ShapeConfig("t", seq, batch,
                                                             "train"))


@pytest.mark.parametrize("remat", ["none", "block"])
def test_microbatch_step_equals_the_unsplit_step(remat):
    """fp32 sgdm (the update is lr * grad): two strided microbatches give
    the whole batch's mean loss and gradient up to f32 summation order."""
    kw = {"remat": remat, "optimizer": "sgdm", "lr": 0.5}
    cfg, one, state, pipe = _port_state("fp32", "cuda", kw)
    _, two, _, _ = _port_state("fp32", "cuda", dict(kw, microbatch=2))
    s1, m1 = one(state, pipe.batch_at(0), 0)
    s2, m2 = two(state, pipe.batch_at(0), 0)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    p0 = flat(state["params"])
    for path, p in flat(s1["params"]).items():
        # the updates, recovered from f32 params: each p - lr * g rounds
        # to the params' own ulp
        ulp = np.finfo(np.float32).eps * np.abs(to_np(p0[path])).max()
        u1 = to_np(p0[path]) - to_np(p)
        u2 = to_np(p0[path]) - to_np(flat(s2["params"])[path])
        np.testing.assert_allclose(u2, u1, rtol=1e-4, atol=4 * ulp)


def test_state_shapes_allocate_nothing_and_match_init_state():
    cfg = get_reduced(ARCH)
    prog = compile_program(cfg, ShapeConfig("t", 16, 2, "train"))
    train = TrainConfig()
    meta = flat(tl.state_shapes(cfg, prog, train)["opt"])
    real = flat(tl.init_state(cfg, prog, train,
                              torch.Generator().manual_seed(0))["opt"])
    assert meta.keys() == real.keys()
    for k, t in meta.items():
        assert t.device.type == "meta"
        assert (t.shape, t.dtype) == (real[k].shape, real[k].dtype)


def test_checkpoint_restart_resumes_bit_identically(tmp_path):
    """paper_sr_bf16 on the cuda backend (SR in UP and in the writeback):
    a run that fails at step 3 restores the step-2 checkpoint and replays
    to the same state, bit for bit, as an unbroken run."""
    cfg, step_fn, state0, pipe = _port_state("paper_sr_bf16", "cuda")
    kw = dict(step_fn=step_fn, batches=pipe.batch_at, meta={}, n_steps=5,
              checkpoint_every=2, key=9)
    clean = run_with_recovery(state=state0,
                              ckpt=Checkpointer(str(tmp_path / "a")), **kw)
    failed = []

    def fail_once(step):
        if step == 3 and not failed:
            failed.append(step)
            raise RuntimeError("injected step failure")

    ckpt = Checkpointer(str(tmp_path / "b"))
    resumed = run_with_recovery(state=state0, ckpt=ckpt,
                                fail_injector=fail_once, **kw)
    assert failed == [3] and ckpt.all_steps() == [2, 4, 5]
    restored, step, _ = ckpt.restore()
    assert step == 5 and restored["step"] == resumed["step"] == 5
    for tree in (resumed, restored):
        for name in ("params", "opt"):
            want = flat(clean[name])
            for path, t in flat(tree[name]).items():
                assert t.dtype == want[path].dtype
                assert torch.equal(t.view(torch.int16), want[path]
                                   .view(torch.int16)), (name, path)


def test_state_from_numpy_carries_a_reference_train_state():
    cfg, jcfg, prog, jprog = _programs("paper_sr_bf16")
    jtrain = JTrain()
    _, opt = jtl.make_train_step(jcfg, jprog, jtrain)
    js = jtl.init_state(jcfg, jprog, jtrain, jax.random.PRNGKey(2), opt)
    js = dict(js, step=jnp.asarray(6, jnp.int32))
    st = state_from_numpy(jax.tree.map(np.asarray, js))
    assert st["step"] == 6 and set(st["opt"]) == {"m", "v"}
    ours = flat(tl.state_shapes(cfg, prog, TrainConfig())["params"])
    for path, t in flat(st["params"]).items():
        assert (t.shape, t.dtype) == (ours[path].shape, ours[path].dtype)
    np.testing.assert_array_equal(
        bits16(st["params"]["embed"]["table"]),
        bits16(js["params"]["embed"]["table"]))


def test_train_cli_runs_on_the_cpu_and_the_loss_falls(tmp_path, capsys):
    args = launch_train.parser().parse_args([
        "--reduced", "--device", "cpu", "--kernel-backend", "cuda",
        "--steps", "10", "--batch", "4", "--seq", "32", "--lr", "3e-3",
        "--log-every", "3", "--ckpt-dir", str(tmp_path)])
    res = launch_train.run(args)
    out = capsys.readouterr().out
    assert "step     9 loss=" in out and "done: 10 steps; loss" in out
    assert np.all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]


def test_train_run_frees_the_initial_state_once_a_step_has_run(
        monkeypatch, tmp_path):
    """launch.train.run hands its state to the loop and keeps none of it:
    after step 0 no tensor of the initial state is alive (granite at the
    reduced size, on the CPU), so a step holds two states, not three."""
    import gc
    import weakref

    from repro_torch.core.tree import tree_leaves

    refs = []
    init_state = tl.init_state

    def spy(*a, **kw):
        state = init_state(*a, **kw)
        refs.extend(weakref.ref(t) for tree in (state["params"],
                                                state["opt"])
                    for _, t in tree_leaves(tree))
        return state

    monkeypatch.setattr(tl, "init_state", spy)
    alive = []

    def on_step(step, metrics, dt):
        gc.collect()
        alive.append(sum(r() is not None for r in refs))

    args = launch_train.parser().parse_args([
        "--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
        "--kernel-backend", "cuda", "--steps", "2", "--batch", "2", "--seq",
        "16", "--ckpt-dir", str(tmp_path)])
    launch_train.run(args, on_step=on_step)
    assert len(refs) > 20 and alive == [0, 0]


def test_train_cli_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])


def test_train_config_defaults_match_the_reference():
    ours = {f.name: getattr(TrainConfig(), f.name)
            for f in dataclasses.fields(TrainConfig)}
    theirs = JTrain()
    for name, value in ours.items():
        want = getattr(theirs, name)
        if name == "kernel_backend":
            want = "reference"
        assert value == want, name
