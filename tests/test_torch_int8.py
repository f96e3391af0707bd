"""int8 propagation on the bucketed backend against the JAX package's
(``recommendation_tpu/graph/bucketed.py:461-607``, ``:724-742``).

The row quantizer (kernel Q1's plain version, ``ops/gather.py::
quantize_rows_plain``) gives the jitted ``_pack_int8_rows``' codes and
scales bit for bit: under ``jax.jit`` XLA makes the scale's division by 127
a product by the f32 reciprocal (eager JAX divides, and its scale differs),
the codes a true division rounded half to even. Rows pushed onto half
quanta test the rounding at ties. int8 packs only where the packed row
keeps 64 f32 words (d >= 249), so the pulls, the chain and the LightGCN
step run at d = 256; below, int8 is f32 bit for bit.

Tolerances: a pull's codes are the same in both packages, so only the
order of the f32 sums differs (rtol 1e-5, atol 1e-6 of the largest
entry). A chain's later layer quantizes the last layer's output, which the
two packages round differently in f32: a code that sits at a tie may flip
by one, moving the layer by one quantum (the row's scale) times that
slot's weight. Those layers are held to the f32 bound plus that quantum
for every flipped code, and the flips are counted. The backward is f32 in
both packages, so gradients are held at the f32 bound. Each JAX reference
is finished (``jax.block_until_ready``) before the port computes: torch's
CPU sums, run while XLA's threads still work, split differently and moved
a gradient past the f32 bound about one run in five.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import recommendation_tpu.graph.bucketed as jb
import recommendation_tpu.sampling as js
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.data.interaction import Interaction as JaxInteraction
from recommendation_tpu.data.synthetic import make_synthetic_dataset
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.graph.device import from_scipy as jax_from_scipy
from recommendation_tpu.models.lightgcn import LightGCN as JaxLightGCN
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.graph import bucketed as tb
from recommendation_tpu_torch.graph.device import DeviceGraph, from_scipy
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.ops.gather import (
    gather_sum,
    gather_sum_plain,
    padded_width,
    quantize_rows,
    quantize_rows_plain,
)
from recommendation_tpu_torch.sampling import PairwiseBatch
from recommendation_tpu_torch.weights import params_from_jax

TIGHT = dict(rtol=1e-5, atol=1e-6)
D = 256
SET = dict(n_users=60, n_items=100, n_interactions=2500, seed=3)
_pack = jax.jit(jb._pack_int8_rows)


def _jax_codes(x: np.ndarray):
    """(codes [N, d], padding codes, scale [N]) of the jitted JAX packer."""
    p = np.asarray(_pack(jnp.asarray(x)))
    codes = p[:, 1:].view(np.int8)
    return codes[:, :x.shape[1]], codes[:, x.shape[1]:], p[:, 0]


def _rows(kind: str, d: int, seed: int = 0, n: int = 4000) -> np.ndarray:
    """Normal rows, or rows pushed onto half quanta (x = (k + 1/2)·scale,
    the row's largest entry kept, so the scale is unchanged)."""
    rng = np.random.default_rng(seed + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if kind == "normal":
        return x
    top = np.abs(x).max(axis=1)
    s = (top * np.float32(1 / 127)).astype(np.float32)
    k = np.clip(np.round(x / s[:, None]), -126, 126)
    h = ((k + np.float32(0.5)) * s[:, None]).astype(np.float32)
    arg = np.argmax(np.abs(x), axis=1)
    h[np.arange(n), arg] = x[np.arange(n), arg]
    return h


def _table(codes: torch.Tensor) -> torch.Tensor:
    """The padded [N, d_pad] table behind a codes view."""
    return torch.as_strided(codes, (codes.shape[0], codes.stride(0)), (codes.stride(0), 1))


@pytest.mark.parametrize("kind", ["normal", "half"])
@pytest.mark.parametrize("d", [250, 256])
def test_codes_and_scales_equal_jitted_jax(d, kind):
    x = _rows(kind, d)
    codes, scale = quantize_rows(torch.from_numpy(x))  # the CPU runs the plain version
    want_codes, want_pad, want_scale = _jax_codes(x)
    assert codes.dtype == torch.int8 and codes.shape == (len(x), d)
    assert codes.stride(0) == padded_width(d) and padded_width(d) % 16 == 0
    assert np.array_equal(scale.numpy(), want_scale)
    assert np.array_equal(codes.numpy(), want_codes)
    assert not want_pad.any() and not _table(codes)[:, d:].any()  # the padding codes are 0
    if kind == "half":  # the rows do sit on ties: round half to even decides them
        q = x / scale.numpy()[:, None]
        assert int(np.sum(np.abs(q - np.trunc(q)) == 0.5)) > 1000 * d


@pytest.mark.parametrize("d", [250, 256])
def test_prescaled_codes_equal_jitted_jax(d):
    """Q1's ``pre`` is the separable pull's ``xp * sep_src_row`` before the
    packer (JAX ``:591-592``); the zero row quantizes to codes 0."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(500, d)).astype(np.float32)
    x[-1] = 0.0
    pre = rng.random(500).astype(np.float32)
    codes, scale = quantize_rows(torch.from_numpy(x), torch.from_numpy(pre))
    want_codes, _, want_scale = _jax_codes(x * pre[:, None])
    assert np.array_equal(codes.numpy(), want_codes) and np.array_equal(scale.numpy(), want_scale)
    assert not codes[-1].any()


def test_plain_pull_dequantizes_each_slot():
    """The plain P1 with an int8 source is the f32 pull of ``code · scale``,
    bit for bit (the kernel's arithmetic). Its epilogue is the int8 chain's
    running sum and requantization, never the folded chain's ``final``."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(40, 250)).astype(np.float32))
    codes, scale = quantize_rows(x)
    idx = torch.from_numpy(rng.integers(0, 40, 300).astype(np.int32))
    ptr = torch.tensor([0, 8, 8, 136, 300])
    val = torch.from_numpy(rng.random(300).astype(np.float32))
    got = gather_sum(codes, idx, ptr, val=val, scale=scale)
    want = gather_sum_plain(codes.float() * scale[:, None], idx, ptr, val=val)
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="no add, final"):
        gather_sum(codes, idx, ptr, scale=scale, acc=torch.zeros(4, 250), final=torch.ones(4))


# -- the pulls, the chain and its VJP against the JAX package --------------------


def _symmetric_values(seed=2, n=300, e=4000):
    """A square symmetric pattern with hub rows whose values do not factor
    (the value path), no row's absolute sum past 1."""
    rng = np.random.default_rng(seed)
    rows = (rng.pareto(0.7, size=e) % (n - 5)).astype(np.int64)
    cols = rng.integers(0, n - 5, e)
    mat = sp.coo_matrix((rng.random(e).astype(np.float32), (rows, cols)), shape=(n, n))
    mat = sp.csr_matrix(mat + mat.T)
    mat.sum_duplicates()
    mat.data /= np.float32(np.abs(mat).sum(axis=1).max())
    return mat


@pytest.fixture(scope="module")
def adjs():
    """name -> (port DeviceAdj, JAX DeviceAdj, scipy matrix): a normalized
    bipartite adjacency (separable values) and a symmetric pattern with
    values that do not factor, both bucketed, both directions sharing
    their row space."""
    train, test = make_synthetic_dataset(**SET)
    norm = JaxInteraction(train, test).norm_adj
    out = {}
    for name, mat in (("separable", norm), ("values", _symmetric_values())):
        ours = from_scipy(mat, backend="bucketed", compute_dtype="int8", device="cpu")
        ref = jax_from_scipy(mat, backend="bucketed", compute_dtype="int8")
        assert ours.sym_rowspace and (ours.pull.sep_dst is not None) == (name == "separable")
        out[name] = (ours, ref, sp.csr_matrix(mat))
    return out


def _x(n, d=D, seed=7):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _close(got, want, **tol):
    want = np.asarray(want)
    tol = {**TIGHT, **tol}
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("which", ["separable", "values"])
def test_pulls_match_jax(adjs, which):
    """``pull`` (node space, each slot weighted) and ``pull_rowspace`` (the
    separable one quantizes ``b ⊙ x`` and scales by ``a`` after the sum)
    against JAX's at int8, and neither equals the f32 pull."""
    ours, ref, _ = adjs[which]
    x = _x(ours.n_cols)
    got = tb.pull(ours.pull, torch.from_numpy(x), "int8")
    _close(got.numpy(), jax.jit(lambda x: jb.pull(ref.pull, x, "int8"))(jnp.asarray(x)))
    assert not torch.equal(got, tb.pull(ours.pull, torch.from_numpy(x), "float32"))
    r = ours.pull.total_rows
    xp = _x(r + 1, seed=8)
    xp[r] = 0.0
    got = tb.pull_rowspace(ours.pull, torch.from_numpy(xp), "int8")
    _close(got.numpy(), _jax_rowspace(ref)(jnp.asarray(xp)))
    assert torch.all(got[r] == 0)


def _jax_rowspace(ref):
    return jax.jit(lambda x: jb.pull_rowspace(ref.pull, x, "int8"))


def _flip_bound(csr, y_port: np.ndarray, y_jax: np.ndarray):
    """What a later layer may move, per row-space row and column, where a
    code of its input flipped between the packages: post · Σ_slots |w| ·
    scale[src] over the flipped codes (w the slot's value, 1 on the
    separable path, post its ``sep_dst``); and the number of flips."""
    sep = csr.sep_dst is not None
    pre = csr.sep_src_row.numpy() if sep else np.ones(len(y_port), np.float32)
    codes, scale = quantize_rows_plain(torch.from_numpy(y_port),
                                       torch.from_numpy(pre) if sep else None)
    want_codes, _, want_scale = _jax_codes(y_jax * pre[:, None] if sep else y_jax)
    flipped = codes.numpy() != want_codes
    quantum = flipped * np.maximum(scale.numpy(), want_scale)[:, None]
    ptr = csr.row_ptr.numpy()
    w = np.ones(csr.n_slots, np.float32) if sep else np.abs(csr.val.numpy())
    weights = sp.csr_matrix((w, csr.ridx.numpy(), ptr[:-1].tolist() + [ptr[-1]]),
                            shape=(len(ptr) - 1, len(y_port)))
    post = csr.sep_dst.numpy() if sep else np.ones(len(y_port), np.float32)
    return post[:, None] * (weights @ quantum), int(flipped.sum())


@pytest.mark.parametrize("which", ["separable", "values"])
def test_chain_layers_and_vjp_match_jax(adjs, which):
    """``bucketed_chain_mean`` at L = 2 and its VJP (a linear probe, so the
    cotangent is the same in both): layer 1 at the f32 bound, layer 2 with a
    quantum for each flipped code, the gradient at the f32 bound."""
    ours, ref, _ = adjs[which]
    fwd = ours.pull
    r = fwd.total_rows
    x = _x(ours.n_rows)
    probe = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    xp = np.concatenate([x[fwd.node_of_row[:r].numpy()], np.zeros((1, D), np.float32)])
    y1 = tb.pull_rowspace(fwd, torch.from_numpy(xp), "int8").numpy()
    jax_pull = _jax_rowspace(ref)
    y1_j = np.asarray(jax_pull(jnp.asarray(xp)))
    _close(y1, y1_j)
    y2 = tb.pull_rowspace(fwd, torch.from_numpy(y1), "int8").numpy()
    y2_j = np.asarray(jax_pull(jnp.asarray(y1_j)))
    bound, flips = _flip_bound(fwd, y1, y1_j)
    assert flips <= 1e-3 * y1.size, flips
    scale = max(np.abs(y2_j).max(), 1.0)
    assert np.all(np.abs(y2 - y2_j) <= 1e-5 * np.abs(y2_j) + 1e-6 * scale + 1.01 * bound)

    def f(x):
        out = jb.bucketed_chain_mean(2, "int8", ref.pull, ref.pull_t, x)
        return jnp.sum(out * probe), out

    (_, want), want_g = jax.block_until_ready(
        jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = tb.bucketed_chain_mean(2, "int8", fwd, ours.pull_t, xt)
    (got * torch.from_numpy(probe)).sum().backward()
    allowed = bound[fwd.gather_pos.numpy().clip(max=r)] / 3.0
    want = np.asarray(want)
    assert np.all(np.abs(got.detach().numpy() - want)
                  <= 1e-5 * np.abs(want) + 1e-6 * max(np.abs(want).max(), 1.0) + 1.01 * allowed)
    _close(xt.grad.numpy(), want_g)
    # the gradient is the f32 chain's: the backward never quantizes
    x32 = torch.from_numpy(x).requires_grad_()
    (tb.bucketed_chain_mean(2, "float32", fwd, ours.pull_t, x32)
     * torch.from_numpy(probe)).sum().backward()
    assert torch.equal(xt.grad, x32.grad)
    # the plain chain: the same forward, bit for bit, and the kernels' gradient
    xq = torch.from_numpy(x).requires_grad_()
    plain = tb.bucketed_chain_mean_plain(2, "int8", fwd, xq)
    assert torch.equal(plain.detach(), got.detach())
    (plain * torch.from_numpy(probe)).sum().backward()
    _close(xq.grad.numpy(), want_g)


# -- the fused layer: P1's int8 epilogue (the running sum and the next codes) ------


def _layer_args(csr):
    """The int8 chain layer's pull arguments on ``csr`` and its ``pre``."""
    sep = csr.sep_dst is not None
    kw = dict(val=None if sep else csr.val, post=csr.sep_dst if sep else None,
              skip=csr.total_rows, schedule=csr.schedule)
    return kw, csr.sep_src_row if sep else None


@pytest.mark.parametrize("which", ["separable", "values"])
@pytest.mark.parametrize("d", [250, 256])
def test_fused_layer_is_the_three_steps(adjs, which, d):
    """``gather_sum(codes, ..., acc, requant=True, pre)`` (the plain version
    the card holds the fused kernel to) equals the three steps it replaces,
    the pull, the add and Q1 on the layer, bit for bit: the first layer (no
    acc), a middle one and the last (no codes); the zero row's codes are 0
    with a zero row's scale."""
    csr = adjs[which][0].pull
    r = csr.total_rows
    kw, pre = _layer_args(csr)
    xp = torch.from_numpy(_x(r + 1, d=d, seed=d))
    xp[r] = 0.0
    acc = torch.from_numpy(_x(r + 1, d=d, seed=d + 1))
    codes, scale = quantize_rows(xp, pre)
    y = gather_sum(codes, csr.ridx, csr.row_ptr, scale=scale, **kw)
    want_codes, want_scale = quantize_rows_plain(y, pre)
    for a, want_total in ((None, y), (acc, acc + y)):
        total, got_codes, got_scale = gather_sum(codes, csr.ridx, csr.row_ptr, scale=scale,
                                                 acc=a, requant=True, pre=pre, **kw)
        assert torch.equal(total, want_total)
        assert torch.equal(got_codes, want_codes) and torch.equal(got_scale, want_scale)
        assert got_codes.stride(0) == padded_width(d) and not _table(got_codes)[:, d:].any()
        assert not got_codes[r].any() and got_scale[r] == quantize_rows_plain(xp[r:])[1][0]
    last = gather_sum(codes, csr.ridx, csr.row_ptr, scale=scale, acc=acc, **kw)
    assert torch.equal(last, acc + y)


def test_int8_chain_quantizes_once_and_fuses_its_layers(adjs, monkeypatch):
    """The int8 chain at L = 3 runs Q1 once, on layer 0's source, and three
    pulls: the first with the next codes asked, the second with the running
    sum and the next codes, the last with the running sum alone. Its output
    equals the three-step chain's (pull, add, Q1 a layer), bit for bit."""
    ours = adjs["separable"][0]
    fwd = ours.pull
    calls = []

    def quant(x, pre=None):
        calls.append(("quant", pre is not None))
        return quantize_rows(x, pre)

    def gsum(*args, acc=None, requant=False, **kw):
        calls.append(("gsum", acc is not None, requant))
        return gather_sum(*args, acc=acc, requant=requant, **kw)

    monkeypatch.setattr(tb, "KERNELS", tb.Ops(tb.gather_rows, gsum, quant))
    x = torch.from_numpy(_x(ours.n_rows))
    got = tb.bucketed_chain_mean(3, "int8", fwd, ours.pull_t, x)
    assert calls == [("quant", True), ("gsum", False, True), ("gsum", True, True),
                     ("gsum", True, False)]
    r = fwd.total_rows
    cur = torch.cat([x[fwd.node_of_row[:r].long()], torch.zeros((1, D))])
    acc = torch.zeros_like(cur)
    for _ in range(3):
        cur = tb.pull_rowspace(fwd, cur, "int8")
        acc = acc + cur
    assert torch.equal(got, (x + acc[fwd.gather_pos.long()]) / 4.0)


def test_fused_layer_refuses_what_it_does_not_take(adjs):
    csr = adjs["separable"][0].pull
    n_out = csr.total_rows + 1
    x = torch.zeros(n_out, 256)
    codes, scale = quantize_rows(x)
    args = (csr.ridx, csr.row_ptr)
    with pytest.raises(TypeError, match="int8 source only"):
        gather_sum(x, *args, requant=True)
    with pytest.raises(TypeError, match="pre with requant only"):
        gather_sum(codes, *args, scale=scale, pre=csr.sep_src_row)
    with pytest.raises(ValueError, match="pre must be float32"):
        gather_sum(codes, *args, scale=scale, requant=True, pre=csr.sep_src_row[1:])
    with pytest.raises(ValueError, match="acc must be float32"):
        gather_sum(codes, *args, scale=scale, acc=x[:, :250], requant=True)
    with pytest.raises(TypeError, match="no add, final or keep_y"):
        gather_sum(codes, *args, scale=scale, acc=x, keep_y=True)


@pytest.mark.parametrize("which", ["separable", "values"])
def test_matmul_and_vjp_match_jax(adjs, which):
    ours, ref, _ = adjs[which]
    x = _x(ours.n_cols, seed=11)

    def f(x):
        return jnp.sum(jnp.tanh(jb.bucketed_matmul(ref.pull, ref.pull_t, x, "int8")) ** 2)

    want, want_g = jax.block_until_ready(jax.jit(jax.value_and_grad(f))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = torch.sum(torch.tanh(tb.bucketed_matmul(ours.pull, ours.pull_t, xt, "int8")) ** 2)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close(xt.grad.numpy(), want_g)


@pytest.mark.parametrize("d", [64, 248])
def test_int8_is_f32_below_249(adjs, d):
    """Below d = 249 the packed row would hold fewer than 64 words, so
    int8 does not pack: the chain, its gradient and the pull are the f32
    ones bit for bit (and no Q1 runs)."""
    assert tb.packer("int8", d) is None and tb.packer("int8", 249) == "int8"
    ours = adjs["separable"][0]
    x = _x(ours.n_rows, d=d)
    outs = []
    for dt in ("float32", "int8"):
        xt = torch.from_numpy(x).requires_grad_()
        out = tb.bucketed_chain_mean(2, dt, ours.pull, ours.pull_t, xt)
        out.square().sum().backward()
        outs.append((out.detach(), xt.grad, tb.pull(ours.pull, torch.from_numpy(x), dt)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# -- LightGCN on the three backends ------------------------------------------------


@pytest.fixture(scope="module")
def lightgcn_step_jax():
    """One LightGCN step at embedding.size 256 on the JAX bucketed graph
    at int8: its parameters, batch, loss and gradients."""
    train, test = make_synthetic_dataset(**SET)
    data = JaxInteraction(train, test)
    ref_g = JaxDeviceGraph(data, backend="bucketed", compute_dtype="int8")
    cfg = {"embedding.size": D, "batch.size": 256}
    jm = JaxLightGCN(jax_default_config(**cfg))
    params, _ = jm.init(jax.random.PRNGKey(0), ref_g)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    users, items, negs, weights, _ = js.epoch_batches(k1, k2, ref_g, 256)
    jbatch = js.PairwiseBatch(users[0], items[0], negs[0], weights[0])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {}, jbatch, ref_g, jax.random.PRNGKey(2))[0]))(params)
    batch = PairwiseBatch(*(torch.from_numpy(np.array(a[0])) for a in (users, items, negs, weights)))
    return (train, test, cfg, jax.device_get(params), batch, float(loss),
            {k: np.asarray(v) for k, v in grads.items()})


def _port_step(backend, compute_dtype, case):
    train, test, cfg, params, batch, *_ = case
    graph = DeviceGraph(Interaction(train, test), backend=backend, compute_dtype=compute_dtype,
                        device="cpu")
    p = {k: v.requires_grad_() for k, v in params_from_jax("lightgcn", params,
                                                             device="cpu").items()}
    loss, _ = build("lightgcn", default_config(**cfg)).loss(p, {}, batch, graph)
    return loss, dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def test_lightgcn_step_on_bucketed_int8_matches_jax(lightgcn_step_jax):
    """The chain's layers quantize here (d = 256): the loss and gradients
    against the JAX step at int8, and the step is not the f32 one."""
    *_, want, want_g = lightgcn_step_jax
    loss, grads = _port_step("bucketed", "int8", lightgcn_step_jax)
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    for name, g in grads.items():
        w = want_g[name]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())
    loss32, _ = _port_step("bucketed", "float32", lightgcn_step_jax)
    assert loss32.item() != loss.item()


@pytest.mark.parametrize("backend", ["dense", "segment"])
def test_dense_and_segment_backends_run_int8_as_f32(lightgcn_step_jax, backend):
    """As in the JAX package, the dense and segment products branch on
    bf16 only: int8 there is the f32 step. The loss is the f32 one bit for
    bit; the gradients too up to the CPU's row-gather backward, whose
    accumulation order moves between two f32 runs by an ulp."""
    loss8, g8 = _port_step(backend, "int8", lightgcn_step_jax)
    loss32, g32 = _port_step(backend, "float32", lightgcn_step_jax)
    assert torch.equal(loss8, loss32)
    for k in g32:
        torch.testing.assert_close(g8[k], g32[k], rtol=1e-6, atol=1e-6 * g32[k].abs().max().item())
    train, test, *_ = lightgcn_step_jax
    graph = DeviceGraph(Interaction(train, test), backend=backend, compute_dtype="int8",
                        device="cpu")
    if backend == "dense":
        assert graph.propagation_matrix is graph.interaction_norm_dense
        assert graph.norm_adj.dense_operand is graph.norm_adj.dense
