"""The port's paper networks against the JAX package, on the CPU.

Same numpy inputs from a seed, or the reference's own parameters carried
across by ``params_from_numpy``, go through both packages at small
sizes: AlexNet's structure at in_hw 99 (its last pool leaves 2 x 2) and
VGG-16's at 32 with narrow channels, MLP widths 32, a GRU 16 / 32 / 16
over T = 6, and the captioning composition (AlexNet's conv stack ->
GRU) at matching widths.  Covered: the config copy, list-holding trees
in JAX's leaf order, ``fixed_quantize`` in its three modes, ``init``,
``_conv`` (NHWC in and out, SAME / VALID, strides, max-pool ties),
``forward`` (the NHWC flatten that FC1's weights assume), ``loss_fn`` and
its gradients, ``conv_up_as_matmul``, the GRU with and without its
``quant`` hook, MLP0, the captioning loss and one ``paper_step``.

The reference backends are held to each other, and the port's cuda
backend (its kernels' plain versions on these CPU tensors) to the JAX
words on ``backend="pallas"`` (interpret mode).  Tolerances, as the
largest |difference| over the largest |reference| of a tensor or a
gradient leaf: f32 compute 1e-5 on outputs and 1e-4 on gradients; bf16
compute 2e-2 (one bf16 step and its carry through a layer) on outputs
and on each gradient leaf of the FC, MLP and GRU layers.  The conv
layers' bf16 gradients are held as a whole, in L2 norm over all conv
leaves: a one-ulp bf16 difference can move a max-pool's argmax and send
that window's gradient to another element, so one leaf's largest entry
says little.  They must lie within 2e-2 of the reference's, or, where
the test computes it, no farther from the reference's bf16 gradients
than those lie from the reference's own f32 gradients (at these sizes
that distance is 2-30%; the port's is 0.2% for most inputs and 8% for
the VGG input of the test, whose argmaxes flip in early pools).
``fixed_quantize`` is held bit for bit given the same uniforms or stream
words.  No test changes process-wide state.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import (FakeTensor,  # noqa: E402
                                           FakeTensorMode)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_nets as jpn  # noqa: E402
from repro.core import rounding as jrounding  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import rnn as jrnn  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import PAPER_NETS  # noqa: E402
from repro_torch.configs import paper_nets as pn  # noqa: E402
from repro_torch.core import rounding  # noqa: E402
from repro_torch.core.tree import (tree_leaves, tree_map,  # noqa: E402
                                   tree_unflatten)
from repro_torch.kernels import outer_accum as koa  # noqa: E402
from repro_torch.kernels import sr_matmul as kmm  # noqa: E402
from repro_torch.models import caption, cnn, rnn  # noqa: E402
from repro_torch.runtime import paper_step as ps  # noqa: E402

F32_OUT, F32_GRAD, BF16_TOL = 1e-5, 1e-4, 2e-2
# the reference backends against each other, and the port's cuda
# backend (plain versions on the CPU) against the JAX pallas words
PAIRS = [("reference", "reference"), ("cuda", "pallas")]


def _narrow(cfg, widths, **kw):
    return dataclasses.replace(
        cfg, convs=tuple(dataclasses.replace(c, out_ch=w)
                         for c, w in zip(cfg.convs, widths)), **kw)


# AlexNet at 99: conv1 23 -> pool 11, conv2 11 -> 5, conv3-5 5 -> pool 2
ALEX = _narrow(pn.ALEXNET, (8, 16, 12, 12, 8), in_hw=99, fcs=(32, 32),
               n_classes=10)
JALEX = _narrow(jpn.ALEXNET, (8, 16, 12, 12, 8), in_hw=99, fcs=(32, 32),
                n_classes=10)
VGG = _narrow(pn.VGG16, (8, 8, 12, 12, 8, 8, 8, 8, 8, 8, 8, 8, 8), in_hw=32,
              fcs=(32, 32), n_classes=10)
JVGG = _narrow(jpn.VGG16, (8, 8, 12, 12, 8, 8, 8, 8, 8, 8, 8, 8, 8),
               in_hw=32, fcs=(32, 32), n_classes=10)
CNNS = {"alexnet": (ALEX, JALEX), "vgg16": (VGG, JVGG)}
MLP = pn.MLPConfig("mlp-s", (32, 32, 32, 32, 32))
JMLP = jpn.MLPConfig("mlp-s", (32, 32, 32, 32, 32))
MLP_IN, MLP_OUT = 32, 16
GRU = pn.GRUConfig("gru-s", n_input=16, n_hidden=32, n_output=16, T=6)
JGRU = jpn.GRUConfig("gru-s", n_input=16, n_hidden=32, n_output=16, T=6)
# the captioning conv stack at 99 with 8 channels out of conv5: 5x5x8
CAP_CNN = _narrow(caption.CAPTION_CNN, (8, 16, 12, 12, 8), in_hw=99)
JCAP_CNN = jpn.CNNConfig("cap", 99, 3, tuple(
    dataclasses.replace(jc, out_ch=c.out_ch, pool=c.pool) for jc, c in
    zip(jpn.ALEXNET.convs, CAP_CNN.convs)), (), 1)
CAP_GRU = pn.GRUConfig("cap-s", n_input=200, n_hidden=16, n_output=8, T=4)
JCAP_GRU = jpn.GRUConfig("cap-s", n_input=200, n_hidden=16, n_output=8, T=4)
# Fig 10's datapath format (benchmarks/fig10_precision.py:27)
FX_DATAPATH = (16, 12)


def rel(got, want) -> float:
    """max |got - want| / max |want|."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_paths(tree) -> list:
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path))
    return out


def carry(jparams):
    """The reference's parameters as the port's (f32 leaves)."""
    return params_from_numpy(jax.tree.map(np.asarray, jparams))


def port_grads(loss_of, params):
    req = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    leaves = [p for _, p in tree_leaves(req)]
    loss = loss_of(req)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _l2(got: list, want: list) -> float:
    g = np.concatenate([np.ravel(a) for a in got]).astype(np.float64)
    w = np.concatenate([np.ravel(a) for a in want]).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def assert_grads(got, want_tree, tol, witness_tree=None):
    """Each leaf within `tol` of its largest reference entry; under bf16
    compute (tol BF16_TOL) the conv leaves as a whole, in L2 norm, within
    `tol` or within the distance of the reference's gradients from
    `witness_tree` (the reference's f32 gradients) where given."""
    want = jax.tree.leaves(want_tree)
    paths = jax_paths(want_tree)
    assert len(got) == len(want) == len(paths)
    conv = [i for i, p in enumerate(paths) if "convs/" in p]
    if tol < BF16_TOL:
        conv = []
    errs = {paths[i]: rel(to_np(got[i]), to_np(want[i]))
            for i in range(len(want)) if i not in conv}
    assert max(errs.values(), default=0.0) <= tol, errs
    if conv:
        w = [to_np(want[i]) for i in conv]
        l2 = _l2([to_np(got[i]) for i in conv], w)
        limit = tol
        if witness_tree is not None:
            wit = jax.tree.leaves(witness_tree)
            limit = _l2(w, [to_np(wit[i]) for i in conv])
        assert l2 <= limit, (l2, limit)


def tol_for(dtype) -> tuple:
    return ((F32_OUT, F32_GRAD) if dtype == "float32"
            else (BF16_TOL, BF16_TOL))


@functools.lru_cache(maxsize=None)
def jinit(name: str, seed: int):
    """The reference's parameters of a small net (cached: JAX arrays are
    immutable)."""
    key = jax.random.PRNGKey(seed)
    if name in CNNS:
        return jcnn.init(key, CNNS[name][1])
    if name == "gru":
        return jrnn.gru_init(key, JGRU)
    return jrnn.mlp_init(key, JMLP, MLP_IN, MLP_OUT)


# ---------------------------------------------------------------------------
# Configs and trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jpn.PAPER_NETS))
def test_paper_net_configs_copy_the_reference(name):
    mine, ref = PAPER_NETS[name], jpn.PAPER_NETS[name]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert type(mine).__name__ == type(ref).__name__


def test_caption_cnn_gives_the_caption_grus_inputs():
    assert caption.n_features(caption.CAPTION_CNN) == 13 * 13 * 256
    assert caption.n_features(caption.CAPTION_CNN) == pn.CAPTION_GRU.n_input
    assert [c.pool for c in caption.CAPTION_CNN.convs] == [2, 2, 0, 0, 0]


def test_tree_leaves_follow_jax_order_with_lists():
    """Twelve list items: index order, not the sorted "0", "1", "10",
    "11", "2" ... of string keys; dict keys sorted inside each item."""
    rng = np.random.RandomState(0)
    tree = {"z": rng.randn(2).astype(np.float32),
            "layers": [{"w": rng.randn(3).astype(np.float32),
                        "b": rng.randn(1).astype(np.float32)}
                       for _ in range(12)]}
    port = params_from_numpy(tree)
    assert isinstance(port["layers"], list)
    paths = [p for p, _ in tree_leaves(port)]
    assert paths == jax_paths(tree)
    assert paths[:4] == ["layers/0/b", "layers/0/w", "layers/1/b",
                         "layers/1/w"]
    for (_, leaf), ref in zip(tree_leaves(port), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(leaf.numpy(), ref)
    leaves = [p * 2 for _, p in tree_leaves(port)]
    back = tree_unflatten(port, leaves)
    assert isinstance(back["layers"], list)
    assert all(a is b for a, b in zip(leaves,
                                      [p for _, p in tree_leaves(back)]))
    with pytest.raises(ValueError):
        tree_unflatten(port, leaves + [leaves[0]])


@pytest.mark.parametrize("net", ["alexnet", "vgg16"])
def test_cnn_init_matches_the_reference_layout(net):
    cfg, jcfg = CNNS[net]
    jp = jinit(net, 1)
    mine = cnn.init(torch.Generator().manual_seed(0), cfg)
    assert [p for p, _ in tree_leaves(mine)] == jax_paths(jp)
    assert [tuple(v.shape) for _, v in tree_leaves(mine)] == \
        [tuple(v.shape) for v in jax.tree.leaves(jp)]
    carried = carry(jp)
    assert isinstance(carried["convs"], list)
    assert [p for p, _ in tree_leaves(carried)] == jax_paths(jp)


def test_rnn_inits_match_the_reference_layout():
    g = torch.Generator().manual_seed(0)
    for mine, jp in (
            (rnn.gru_init(g, GRU), jinit("gru", 2)),
            (rnn.mlp_init(g, MLP, MLP_IN, MLP_OUT), jinit("mlp0", 3))):
        assert [p for p, _ in tree_leaves(mine)] == jax_paths(jp)
        assert [tuple(v.shape) for _, v in tree_leaves(mine)] == \
            [tuple(v.shape) for v in jax.tree.leaves(jp)]


# ---------------------------------------------------------------------------
# fixed_quantize
# ---------------------------------------------------------------------------


def _fq_input(n: int = 1000) -> np.ndarray:
    rng = np.random.RandomState(1)
    x = rng.randn(n).astype(np.float32) * 3
    x[:8] = [0.5 / 256, 1.5 / 256, -2.5 / 256, 1e9, -1e9, 200.0, -200.0, 0]
    return x.reshape(40, -1)


@pytest.mark.parametrize("bits", [(16, 8), (32, 16), (16, 12), (16, 7)])
def test_fixed_quantize_nearest_is_bit_equal(bits):
    x = _fq_input()
    want = jrounding.fixed_quantize(jnp.asarray(x),
                                    jrounding.FixedPointConfig(*bits))
    got = rounding.fixed_quantize(t(x), rounding.FixedPointConfig(*bits))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("mode", ["sr", "sr_lo"])
@pytest.mark.parametrize("bits", [(32, 16), (16, 7)])
def test_fixed_quantize_sr_is_bit_equal_given_the_entropy(mode, bits):
    """The reference's uniforms (sr) or stream words (sr_lo), drawn from
    its key, injected into the port."""
    x = _fq_input()
    key = jax.random.PRNGKey(3)
    want = jrounding.fixed_quantize(
        jnp.asarray(x), jrounding.FixedPointConfig(*bits, mode), key)
    cfg = rounding.FixedPointConfig(*bits, mode)
    if mode == "sr":
        u = np.asarray(jax.random.uniform(key, x.shape, dtype=jnp.float32))
        got = rounding.fixed_quantize(t(x), cfg, uniforms=t(u))
    else:
        n_words = (x.size + 31) // 32 + 1
        words = np.asarray(jax.random.bits(key, (n_words,), jnp.uint32))
        got = rounding.fixed_quantize(
            t(x), cfg, stream=t(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("mode", ["sr", "sr_lo"])
def test_fixed_quantize_draws_from_its_generator(mode):
    """Same seed, same bits; every value lands on one of the two grid
    points around it; the mean error is near zero (unbiased)."""
    x = t(np.random.RandomState(2).randn(64, 64).astype(np.float32))
    cfg = rounding.FixedPointConfig(16, 7, mode)
    a = rounding.fixed_quantize(x, cfg, torch.Generator().manual_seed(5))
    b = rounding.fixed_quantize(x, cfg, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    lo = torch.floor(x * cfg.scale) / cfg.scale
    assert bool(((a == lo) | (a == lo + 1 / cfg.scale)).all())
    assert abs(float((a - x).mean())) < 0.1 / cfg.scale
    with pytest.raises(ValueError):
        rounding.fixed_quantize(x, cfg)


# ---------------------------------------------------------------------------
# The CNN
# ---------------------------------------------------------------------------


CONV_CASES = [
    ("alex-conv1", 27, 3, pn.ConvSpec(8, 11, 4, "VALID", 2)),
    ("alex-conv2", 11, 8, pn.ConvSpec(16, 5, pool=2)),
    ("vgg-conv", 10, 3, pn.ConvSpec(8, 3, pool=2)),
    ("same-even-k", 9, 4, pn.ConvSpec(6, 2)),
    ("same-stride2-odd", 11, 4, pn.ConvSpec(6, 3, 2)),
    ("same-stride2-even", 10, 4, pn.ConvSpec(6, 3, 2, pool=2)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,hw,ci,spec", CONV_CASES,
                         ids=[c[0] for c in CONV_CASES])
def test_conv_matches_the_reference(name, hw, ci, spec, dtype):
    rng = np.random.RandomState(4)
    x = rng.randn(2, hw, hw, ci).astype(np.float32)
    w = (rng.randn(spec.kernel, spec.kernel, ci, spec.out_ch)
         / spec.kernel).astype(np.float32)
    b = rng.randn(spec.out_ch).astype(np.float32) * 0.1
    jspec = jpn.ConvSpec(**dataclasses.asdict(spec))
    want = jcnn._conv(jnp.asarray(x).astype(dtype), jspec,
                      {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    got = cnn._conv(t(x).to(getattr(torch, dtype)), spec,
                    {"w": t(w), "b": t(b)})
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == tuple(want.shape)
    assert rel(to_np(got), to_np(want)) <= tol_for(dtype)[0]


def test_maxpool_sends_a_ties_gradient_where_the_reference_does():
    """Integer-valued inputs through a 1x1 identity conv: many 2x2
    windows hold ties; the input gradient must be the reference's, bit
    for bit."""
    rng = np.random.RandomState(5)
    x = rng.randint(0, 3, (2, 8, 8, 4)).astype(np.float32)
    g = rng.randn(2, 4, 4, 4).astype(np.float32)
    p = {"w": np.eye(4, dtype=np.float32)[None, None],
         "b": np.zeros(4, np.float32)}
    spec = pn.ConvSpec(4, 1, pool=2)
    _, vjp = jax.vjp(lambda a: jcnn._conv(
        a, jpn.ConvSpec(4, 1, pool=2), jax.tree.map(jnp.asarray, p)),
        jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = t(x).requires_grad_()
    y = cnn._conv(xt, spec, {k: t(v) for k, v in p.items()})
    got, = torch.autograd.grad(y, xt, t(g))
    np.testing.assert_array_equal(got.numpy(), want)
    # ties exist, and each window whose max passed the relu sent its
    # gradient to one element only
    win = x.reshape(2, 4, 2, 4, 2, 4).transpose(0, 1, 3, 5, 2, 4)
    peak = win.max(axis=(-2, -1))
    assert (np.sum(win == peak[..., None, None], axis=(-2, -1))
            > 1).sum() > 10
    assert np.count_nonzero(want) == np.count_nonzero(peak > 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ports,jax_backend", PAIRS)
@pytest.mark.parametrize("net", ["alexnet", "vgg16"])
def test_cnn_loss_and_grads_match_the_reference(net, ports, jax_backend,
                                                 dtype):
    cfg, jcfg = CNNS[net]
    jp = jinit(net, 1)
    rng = np.random.RandomState(6)
    images = rng.randn(3, cfg.in_hw, cfg.in_hw, 3).astype(np.float32)
    labels = rng.randint(0, cfg.n_classes, 3).astype(np.int32)
    jbatch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    cd = getattr(jnp, dtype)
    jl, jg = jax.value_and_grad(lambda p: jcnn.loss_fn(
        jcfg, p, jbatch, compute_dtype=cd, backend=jax_backend))(jp)
    jlogits = jcnn.forward(jcfg, jp, jbatch["images"], compute_dtype=cd,
                           backend=jax_backend)
    params = carry(jp)
    batch = {"images": t(images), "labels": t(labels)}
    td = getattr(torch, dtype)
    logits = cnn.forward(cfg, params, batch["images"], compute_dtype=td,
                         backend=ports)
    loss, grads = port_grads(lambda p: cnn.loss_fn(
        cfg, p, batch, compute_dtype=td, backend=ports), params)
    out_tol, grad_tol = tol_for(dtype)
    # the pallas words run bf16 operands even under f32 compute
    if jax_backend == "pallas":
        out_tol = grad_tol = BF16_TOL
    assert logits.dtype == torch.float32
    assert rel(to_np(logits), np.asarray(jlogits)) <= out_tol
    assert rel(float(loss), float(jl)) <= out_tol
    witness = None
    if grad_tol == BF16_TOL:
        witness = jax.grad(lambda p: jcnn.loss_fn(
            jcfg, p, jbatch, compute_dtype=jnp.float32))(jp)
    assert_grads(grads, jg, grad_tol, witness)


def test_cnn_flattens_in_nhwc_order():
    """AlexNet's last pool leaves 2 x 2 x 8: FC1 reads the features in
    NHWC order (as the reference does), not torch's NCHW order."""
    cfg = dataclasses.replace(ALEX, fcs=())
    params = cnn.init(torch.Generator().manual_seed(2), cfg)
    x = t(np.random.RandomState(7).randn(2, 99, 99, 3).astype(np.float32))
    feat = x
    for c, p in zip(cfg.convs, params["convs"]):
        feat = cnn._conv(feat, c, p)
    assert tuple(feat.shape) == (2, 2, 2, 8)
    w, b = params["fcs"][0]["w"], params["fcs"][0]["b"]
    logits = cnn.forward(cfg, params, x, compute_dtype=torch.float32)
    nhwc = feat.reshape(2, -1).double() @ w.double() + b.double()
    nchw = feat.permute(0, 3, 1, 2).reshape(2, -1).double() @ w.double()
    assert rel(logits.numpy(), nhwc.numpy()) <= F32_OUT
    assert rel(logits.numpy(), nchw.numpy()) > 0.1


CONV_UP_CASES = [(3, 1, "SAME", 8, 3, 4), (5, 1, "SAME", 7, 4, 6),
                 (11, 4, "VALID", 23, 3, 5), (1, 1, "SAME", 6, 5, 3)]


@pytest.mark.parametrize("ports,jax_backend", PAIRS)
@pytest.mark.parametrize("k,stride,pad,hw,ci,co", CONV_UP_CASES)
def test_conv_up_as_matmul_matches_the_reference_and_autograd(
        k, stride, pad, hw, ci, co, ports, jax_backend):
    rng = np.random.RandomState(8)
    x = rng.randn(2, hw, hw, ci).astype(np.float32)
    ho = (hw - k) // stride + 1 if pad == "VALID" else hw
    dy = rng.randn(2, ho, ho, co).astype(np.float32)
    want = np.asarray(jcnn.conv_up_as_matmul(
        jnp.asarray(x), jnp.asarray(dy), k, stride, pad,
        backend=jax_backend))
    got = cnn.conv_up_as_matmul(t(x), t(dy), k, stride, pad, backend=ports)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (k, k, ci, co)
    assert rel(got.numpy(), want) <= F32_OUT
    # autograd's conv dW (HWIO) on the same x and dY
    w = torch.zeros((co, ci, k, k), dtype=torch.float64, requires_grad=True)
    y = torch.nn.functional.conv2d(
        t(x).double().permute(0, 3, 1, 2), w, stride=stride,
        padding=k // 2 if pad == "SAME" else 0)
    dw, = torch.autograd.grad(y, w, t(dy).double().permute(0, 3, 1, 2))
    assert rel(got.numpy(), dw.permute(2, 3, 1, 0).numpy()) <= F32_OUT


def test_conv_up_as_matmul_runs_outer_accum_on_f32_contiguous_taps(
        monkeypatch):
    """The cuda backend issues one outer_accum word per tap, each on f32
    contiguous (T, Ci) and (T, Co) operands — what the f32 kernel takes."""
    seen = []

    def spy(x, dy, **kw):
        seen.append((x.dtype, dy.dtype, x.is_contiguous(),
                     dy.is_contiguous(), tuple(x.shape), tuple(dy.shape)))
        return koa.outer_accum_plain(x, dy, **kw)

    monkeypatch.setattr(koa, "outer_accum", spy)
    x = torch.randn(2, 9, 9, 3, dtype=torch.bfloat16)
    dy = torch.randn(2, 9, 9, 4, dtype=torch.bfloat16)
    cnn.conv_up_as_matmul(x, dy, 3, backend="cuda")
    assert seen == [(torch.float32, torch.float32, True, True, (162, 3),
                     (162, 4))] * 9
    with pytest.raises(ValueError, match="backend"):
        cnn.conv_up_as_matmul(x, dy, 3, backend="pallas")


# ---------------------------------------------------------------------------
# The GRU, MLP0 and the captioning net
# ---------------------------------------------------------------------------


def _gru_data(seed: int = 9, cfg=GRU):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, cfg.T, cfg.n_input).astype(np.float32),
            rng.randn(3, cfg.T, cfg.n_output).astype(np.float32))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "fx-ste"])
@pytest.mark.parametrize("ports,jax_backend", PAIRS)
def test_gru_matches_the_reference(ports, jax_backend, quant):
    """gru_forward and gru_loss's gradients, with and without Fig 10's
    straight-through fixed-point hook (benchmarks/fig10_precision.py:43).
    Under the hook a value within an f32 ulp of a grid midpoint may round
    the other way, so outputs are held to one grid step (2^-12) instead
    of 1e-5."""
    x, y = _gru_data()
    jp = jinit("gru", 2)
    jq = pq = None
    out_tol, grad_tol = F32_OUT, F32_GRAD
    if quant:
        jfx = jrounding.FixedPointConfig(*FX_DATAPATH)
        fx = rounding.FixedPointConfig(*FX_DATAPATH)

        def jq(a):
            return a + jax.lax.stop_gradient(
                jrounding.fixed_quantize(a, jfx) - a)

        def pq(a):
            return a + (rounding.fixed_quantize(a, fx) - a).detach()
    jys, jh = jrnn.gru_forward(JGRU, jp, jnp.asarray(x), jq,
                               backend=jax_backend)
    jl, jg = jax.value_and_grad(lambda p: jrnn.gru_loss(
        JGRU, p, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jq,
        backend=jax_backend))(jp)
    params = carry(jp)
    ys, h = rnn.gru_forward(GRU, params, t(x), pq, backend=ports)
    loss, grads = port_grads(lambda p: rnn.gru_loss(
        GRU, p, {"x": t(x), "y": t(y)}, pq, backend=ports), params)
    assert ys.shape == (3, GRU.T, GRU.n_output) and h.shape == (3, 32)
    if quant:
        step = 2.0 ** -FX_DATAPATH[1]
        assert np.abs(ys.numpy() - np.asarray(jys)).max() <= step
        assert np.abs(h.numpy() - np.asarray(jh)).max() <= step
        # the grid holds every output of the hooked datapath
        assert np.all(ys.numpy() * 2 ** FX_DATAPATH[1]
                      == np.round(ys.numpy() * 2 ** FX_DATAPATH[1]))
    else:
        assert rel(ys.numpy(), np.asarray(jys)) <= out_tol
        assert rel(h.numpy(), np.asarray(jh)) <= out_tol
    assert rel(float(loss), float(jl)) <= out_tol
    assert_grads(grads, jg, grad_tol)


def test_gru_keeps_three_words_a_step_on_the_f32_path(monkeypatch):
    """Per time step: x_t . wx, h . wh and h . wo, each one sr_matmul
    call with f32 operands (the input product is not hoisted), and in
    the backward one outer_accum UP word each."""
    calls = []
    real_mm, real_oa = kmm.sr_matmul, koa.outer_accum

    def mm(a, b, *args, **kw):
        calls.append(("mm", a.dtype, b.dtype, tuple(a.shape),
                      tuple(b.shape)))
        return real_mm(a, b, *args, **kw)

    def oa(x, dy, **kw):
        calls.append(("up", x.dtype, dy.dtype, tuple(x.shape),
                      tuple(dy.shape)))
        return real_oa(x, dy, **kw)

    monkeypatch.setattr(kmm, "sr_matmul", mm)
    monkeypatch.setattr(koa, "outer_accum", oa)
    x, y = _gru_data()
    params = rnn.gru_init(torch.Generator().manual_seed(0), GRU)
    rnn.gru_forward(GRU, params, t(x), backend="cuda")
    ff = [c for c in calls if c[0] == "mm"]
    assert len(ff) == 3 * GRU.T
    assert all(c[1] == c[2] == torch.float32 for c in ff)
    assert [c[4] for c in ff[:3]] == [(16, 96), (32, 96), (32, 16)]
    calls.clear()
    port_grads(lambda p: rnn.gru_loss(GRU, p, {"x": t(x), "y": t(y)},
                                      backend="cuda"), params)
    ups = [c for c in calls if c[0] == "up"]
    assert len(ups) == 3 * GRU.T
    assert all(c[1] == c[2] == torch.float32 for c in ups)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ports,jax_backend", PAIRS)
def test_mlp_matches_the_reference(ports, jax_backend, dtype):
    rng = np.random.RandomState(10)
    x = rng.randn(4, MLP_IN).astype(np.float32)
    y = rng.randn(4, MLP_OUT).astype(np.float32)
    jp = jinit("mlp0", 3)
    cd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(p):
        return jnp.mean((jrnn.mlp_forward(JMLP, p, jnp.asarray(x),
                                          compute_dtype=cd,
                                          backend=jax_backend) - y) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jp)
    jout = jrnn.mlp_forward(JMLP, jp, jnp.asarray(x), compute_dtype=cd,
                            backend=jax_backend)
    params = carry(jp)
    out = rnn.mlp_forward(MLP, params, t(x), compute_dtype=td,
                          backend=ports)
    loss, grads = port_grads(lambda p: torch.mean((rnn.mlp_forward(
        MLP, p, t(x), compute_dtype=td, backend=ports) - t(y)) ** 2),
        params)
    out_tol, grad_tol = tol_for(dtype)
    if jax_backend == "pallas":
        out_tol = grad_tol = BF16_TOL
    assert out.dtype == torch.float32
    assert rel(out.numpy(), np.asarray(jout)) <= out_tol
    assert rel(float(loss), float(jl)) <= out_tol
    assert_grads(grads, jg, grad_tol)


def _jax_caption_loss(jp, images, y, backend):
    """The reference composition (benchmarks/fig16_suite.py:60-81):
    its conv stack, flattened, repeated over T, into its GRU."""
    x = jnp.asarray(images).astype(jnp.bfloat16)
    for c, p in zip(JCAP_CNN.convs, jp["cnn"]["convs"]):
        x = jcnn._conv(x, c, p)
    feat = x.reshape(x.shape[0], -1).astype(jnp.float32)
    xs = jnp.repeat(feat[:, None], JCAP_GRU.T, axis=1)
    ys, _ = jrnn.gru_forward(JCAP_GRU, jp["gru"], xs, backend=backend)
    return jnp.mean((ys - jnp.asarray(y)) ** 2)


@pytest.mark.parametrize("ports,jax_backend", PAIRS)
def test_caption_loss_matches_the_reference(ports, jax_backend):
    rng = np.random.RandomState(11)
    images = rng.randn(2, 99, 99, 3).astype(np.float32)
    y = rng.randn(2, CAP_GRU.T, CAP_GRU.n_output).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    jconvs = jcnn.init(k1, dataclasses.replace(JCAP_CNN))["convs"]
    jp = {"cnn": {"convs": jconvs}, "gru": jrnn.gru_init(k2, JCAP_GRU)}
    jl, jg = jax.value_and_grad(lambda p: _jax_caption_loss(
        p, images, y, jax_backend))(jp)
    params = carry(jp)
    assert caption.n_features(CAP_CNN) == CAP_GRU.n_input
    loss, grads = port_grads(lambda p: caption.loss_fn(
        p, {"images": t(images), "y": t(y)}, gcfg=CAP_GRU, ccfg=CAP_CNN,
        backend=ports), params)
    # bf16 convs feed an f32 GRU: the features carry bf16 rounding
    assert rel(float(loss), float(jl)) <= BF16_TOL
    assert_grads(grads, jg, BF16_TOL)


# ---------------------------------------------------------------------------
# paper_step
# ---------------------------------------------------------------------------


def _small_nets() -> dict:
    """name -> the port's PaperNet of each kind at its small size."""
    return {
        "alexnet": ps.PaperNet("alexnet", "cnn", ALEX),
        "mlp0": ps.PaperNet("mlp0", "mlp", MLP, n_in=MLP_IN, n_out=MLP_OUT),
        "gru": ps.PaperNet("gru", "gru", GRU),
        "caption": ps.PaperNet("caption", "caption", CAP_GRU, CAP_CNN),
    }


def _jax_loss(name, backend):
    if name == "alexnet":
        return lambda p, b: jcnn.loss_fn(JALEX, p, b, backend=backend)
    if name == "mlp0":
        return lambda p, b: jnp.mean((jrnn.mlp_forward(
            JMLP, p, b["x"], backend=backend) - b["y"]) ** 2)
    if name == "gru":
        return lambda p, b: jrnn.gru_loss(JGRU, p, b, backend=backend)
    return lambda p, b: _jax_caption_loss(p, b["images"], b["y"], backend)


@pytest.mark.parametrize("ports,jax_backend", PAIRS)
@pytest.mark.parametrize("name", ["alexnet", "mlp0", "gru", "caption"])
def test_paper_step_matches_the_reference_sgd(name, ports, jax_backend):
    """One SGD step (p - lr * g, benchmarks/fig10_precision.py:50-59) of
    each kind of net from the reference's parameters and batch; then a
    step with Fig 10's nearest fixed-point writeback (16-bit, 7 fraction
    bits), held to one grid step."""
    net = _small_nets()[name]
    params = ps.init_params(net, torch.Generator().manual_seed(6))
    batch = ps.synthetic_batch(net, 2, torch.Generator().manual_seed(7))
    jp = jax.tree.map(lambda a: jnp.asarray(a.numpy()), params)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    lr = 0.05
    jl, jg = jax.value_and_grad(_jax_loss(name, jax_backend))(jp, jb)
    want = jax.tree.map(lambda p, g: p - lr * g, jp, jg)
    step = ps.make_paper_step(net, lr=lr, backend=ports, device="cpu")
    new, met = step(params, batch, key=0)
    tol = F32_GRAD if name == "gru" else BF16_TOL
    assert rel(float(met["loss"]), float(jl)) <= tol
    assert [p for p, _ in tree_leaves(new)] == jax_paths(want)
    # the update, p_new - p_old, against the reference's
    p0 = jax.tree.leaves(jp)
    assert_grads([to_np(v) - np.asarray(a) for (_, v), a in
                  zip(tree_leaves(new), p0)],
                 jax.tree.map(lambda a, b: a - b, want, jp), tol)
    # and exactly p - lr * g of the port's own gradients
    _, grads = port_grads(lambda p: ps.loss_fn(net, p, batch, backend=ports),
                          params)
    for (_, v), (_, a), g in zip(tree_leaves(new), tree_leaves(params),
                                 grads):
        assert torch.equal(v, a - lr * g)
    gn = np.sqrt(sum(float(jnp.sum(g ** 2)) for g in jax.tree.leaves(jg)))
    assert rel(float(met["grad_norm"]), gn) <= tol
    # the old params are untouched
    again = ps.init_params(net, torch.Generator().manual_seed(6))
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_leaves(params), tree_leaves(again)))
    wb = rounding.FixedPointConfig(16, 7)
    qstep = ps.make_paper_step(net, lr=lr, backend=ports, device="cpu",
                               writeback=wb)
    qnew, _ = qstep(params, batch, key=0)
    for (_, got), ref in zip(tree_leaves(qnew), jax.tree.leaves(want)):
        jq = np.asarray(jrounding.fixed_quantize(
            ref, jrounding.FixedPointConfig(16, 7)))
        assert np.abs(got.numpy() - jq).max() <= 1 / wb.scale


def test_paper_step_sr_writeback_draws_from_the_generator():
    net = _small_nets()["gru"]
    params = ps.init_params(net, torch.Generator().manual_seed(6))
    batch = ps.synthetic_batch(net, 2, torch.Generator().manual_seed(7))
    step = ps.make_paper_step(net, lr=0.05, device="cpu",
                              writeback=rounding.FixedPointConfig(16, 7,
                                                                  "sr"))
    a, _ = step(params, batch, 0, torch.Generator().manual_seed(1))
    b, _ = step(params, batch, 0, torch.Generator().manual_seed(1))
    c, _ = step(params, batch, 0, torch.Generator().manual_seed(2))
    la, lb, lc = ([v for _, v in tree_leaves(s)] for s in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not all(torch.equal(x, y) for x, y in zip(la, lc))
    assert all(bool((v * 128 == torch.round(v * 128)).all()) for v in la)


def test_paper_step_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = _small_nets()["mlp0"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.make_paper_step(net, lr=0.1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.make_paper_step(net, lr=0.1, device="cuda")
    with pytest.raises(ValueError, match="backend"):
        ps.make_paper_step(net, lr=0.1, backend="pallas", device="cpu")


# parameters of each net at its published width: AlexNet's 62.4M and
# VGG-16's 138.4M as commonly counted; the GRUs' 3-gate tables; the
# captioning net adds AlexNet's five convs (3,747,200) to its GRU
FULL_PARAMS = {"paper-alexnet": 62378344, "paper-vgg16": 138357544,
               "paper-mlp0": 5 * 2560 * 2560 + 2560 * 256 + 5 * 2560 + 256,
               "paper-gru": 2 * 2048 * 6144 + 6144 + 2048 * 2048,
               "paper-captioning-gru": 43264 * 30000 + 10000 * 30000
               + 30000 + 10000 * 10000 + 3747200}


@pytest.mark.parametrize("name", sorted(jpn.PAPER_NETS))
def test_full_width_nets_build_without_allocating(name):
    """Every net at its published width, its init run on fake tensors
    (shapes and dtypes, no storage): parameter count and leaf shapes
    against the reference's eval_shape."""
    net = ps.paper_net(name)
    with FakeTensorMode():
        params = ps.init_params(net, torch.Generator().manual_seed(0))
    leaves = tree_leaves(params)
    assert all(isinstance(v, FakeTensor) for _, v in leaves)
    assert sum(v.numel() for _, v in leaves) == FULL_PARAMS[name]
    assert ps.train_flops(net, 1) > 0
    if net.kind == "caption":
        return
    jcfg = jpn.PAPER_NETS[name]
    init = {"cnn": jcnn.init, "gru": jrnn.gru_init,
            "mlp": jrnn.mlp_init}[net.kind]
    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.PRNGKey(0))
    assert [tuple(v.shape) for _, v in leaves] == \
        [tuple(v.shape) for v in jax.tree.leaves(shapes)]
    assert [p for p, _ in leaves] == jax_paths(shapes)
