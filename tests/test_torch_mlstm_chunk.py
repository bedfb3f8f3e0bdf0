"""The port's ``mlstm_chunk`` wrapper against the JAX reference.

On CPU tensors the wrapper computes its plain-torch version
(``ref.mlstm_chunkwise``).  It is held against the reference's Pallas
kernel run in interpret mode (as ``tests/test_kernels.py`` runs it) and
against the sequential oracle of both packages over the reference's
``MLSTM_CASES`` at the reference's atol 5e-5; chunk invariance within
2e-4; and the reference's kernel-to-model-path check at atol 5e-4.
bf16 inputs at the tensor-core route's shapes take that route's plain
version, which rounds three operands to bf16 (``operand_dtype``): it is
held to the Pallas kernel and the oracle at the port's bf16 tolerance
(atol 2e-2, rtol 1e-2), and its gates-first stabilisers (``mlstm_gates``)
to the chunk walk's bit for bit.  The CUDA kernels themselves are held
against the plain versions on the card by ``test_torch_mlstm_chunk_cuda.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.mlstm_chunk.ops import mlstm_chunk as jax_mlstm_chunk
from repro.kernels.mlstm_chunk.ref import mlstm_sequential as jax_sequential
from repro.models import xlstm as jxlstm
from repro.runconfig import RunConfig as JRunConfig
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.mlstm_chunk import ops
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunkwise,
                                                 mlstm_gates,
                                                 mlstm_sequential)
from repro_torch.models import xlstm
from repro_torch.runconfig import RunConfig

# the reference's MLSTM_CASES (tests/test_kernels.py): (B, S, H, P, chunk)
MLSTM_CASES = [
    (2, 128, 2, 32, 32), (1, 256, 4, 64, 64), (2, 64, 1, 16, 16),
    (1, 512, 2, 32, 128), (1, 128, 2, 32, 128),
]
ATOL = 5e-5
# shapes that take the wgmma route in bf16: (B, S, H, P, chunk)
WGMMA_CASES = [(1, 256, 2, 64, 128), (1, 512, 1, 128, 256),
               (2, 256, 1, 128, 128), (1, 512, 1, 64, 256)]
BF16_TOL = dict(atol=2e-2, rtol=1e-2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, P, seed, scale=0.5):
    """numpy draws with the reference test's distributions."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    q, k, v = (n(B, S, H, P) * scale, n(B, S, H, P) * scale / P ** 0.5,
               n(B, S, H, P) * scale)
    logi = n(B, S, H)
    logf = -np.logaddexp(0.0, -n(B, S, H) * 2.0).astype(np.float32)
    return q, k, v, logi, logf


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("case", MLSTM_CASES,
                         ids=lambda c: "B{}S{}H{}P{}C{}".format(*c))
def test_mlstm_chunk_matches_reference(case):
    B, S, H, P, chunk = case
    arrs = _inputs(B, S, H, P, seed=S * H + P)
    got = ops.mlstm_chunk(*_t(arrs), chunk=chunk)
    assert got.shape == (B, S, H, P) and got.dtype == torch.float32
    jx = [jnp.asarray(a) for a in arrs]
    pallas = np.asarray(jax_mlstm_chunk(*jx, chunk=chunk))   # interpret mode
    oracle = np.asarray(jax_sequential(*jx))
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), oracle, atol=ATOL)
    np.testing.assert_allclose(mlstm_sequential(*_t(arrs)).numpy(), oracle,
                               atol=ATOL)


def test_mlstm_chunk_size_invariance():
    arrs = _t(_inputs(1, 256, 2, 32, seed=11, scale=1.0))
    outs = [ops.mlstm_chunk(*arrs, chunk=c) for c in (32, 64, 256)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0].numpy(), o.numpy(), atol=2e-4)


def test_mlstm_kernel_matches_model_path():
    """The wrapper's numerics == the reference model's chunked scan
    (``repro.models.xlstm.mlstm_apply``), composed as the reference's own
    test composes its kernel."""
    jcfg, cfg = jax_smoke("xlstm-1.3b"), get_smoke_config("xlstm-1.3b")
    jp = jxlstm.mlstm_init(jax.random.key(0), jcfg, jnp.float32)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    u = np.random.default_rng(1).standard_normal((2, 64, cfg.d_model),
                                                 dtype=np.float32)
    want = np.asarray(jxlstm.mlstm_apply(jp, jnp.asarray(u), jcfg,
                                         JRunConfig(mlstm_chunk=16)))
    ut = torch.from_numpy(u)
    q, k, v, logi, logf, z = xlstm._mlstm_qkvg(p, ut, cfg)
    h = ops.mlstm_chunk(q, k, v, logi, logf, chunk=16)
    got = xlstm._mlstm_out(p, h, z, ut, cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)
    got = xlstm.mlstm_apply(p, ut, cfg, RunConfig(mlstm_chunk=16))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


def test_bf16_in_bf16_out_and_knobs_inert():
    arrs = _t(_inputs(1, 64, 2, 16, seed=2))
    q, k, v = (t.bfloat16() for t in arrs[:3])
    base = ops.mlstm_chunk(q, k, v, *arrs[3:], chunk=16)
    assert base.dtype == torch.bfloat16
    tuned = ops.mlstm_chunk(q, k, v, *arrs[3:], chunk=16, num_warps=8,
                            pipeline=3)
    assert torch.equal(base, tuned)
    want = mlstm_chunkwise(q.float(), k.float(), v.float(), *arrs[3:], 16)
    np.testing.assert_allclose(base.float().numpy(), want.numpy(),
                               atol=2e-2, rtol=1e-2)


def test_chunk_is_capped_at_the_sequence_and_counts_no_launch():
    arrs = _t(_inputs(1, 48, 1, 32, seed=4))
    before = ops.launches
    np.testing.assert_allclose(ops.mlstm_chunk(*arrs, chunk=256).numpy(),
                               ops.mlstm_chunk(*arrs, chunk=48).numpy(),
                               atol=0)
    assert ops.launches == before          # CPU: the plain version


def test_wrapper_errors_on_cpu():
    q, k, v, li, lf = _t(_inputs(1, 64, 1, 32, seed=0))
    with pytest.raises(ValueError, match="head width"):
        ops.mlstm_chunk(*_t(_inputs(1, 64, 1, 48, seed=0)), chunk=16)
    with pytest.raises(ValueError, match="divide"):
        ops.mlstm_chunk(*_t(_inputs(1, 100, 1, 32, seed=0)), chunk=64)
    with pytest.raises(ValueError, match="positive int"):
        ops.mlstm_chunk(q, k, v, li, lf, chunk=0)
    with pytest.raises(TypeError, match="q is"):
        ops.mlstm_chunk(q, k.bfloat16(), v, li, lf)
    with pytest.raises(TypeError, match="float32"):
        ops.mlstm_chunk(q, k, v, li.double(), lf)
    with pytest.raises(ValueError, match=r"\[B,S,H\]"):
        ops.mlstm_chunk(q, k, v, li[:, :32], lf)
    with pytest.raises(ValueError, match="one shape"):
        ops.mlstm_chunk(q, k[:, :32], v, li, lf)
    with pytest.raises(TypeError, match="tensor"):
        ops.mlstm_chunk(q.numpy(), k, v, li, lf)


def _sequential_f64(q, k, v, logi, logf):
    """The oracle's recurrence in float64, for the rounding of the float32
    versions."""
    B, S, H, P = q.shape
    q, k, v, logi, logf = (t.double() for t in (q, k, v, logi, logf))
    c = torch.zeros((B, H, P, P), dtype=torch.float64)
    n = torch.zeros((B, H, P), dtype=torch.float64)
    m = torch.full((B, H), -1e30, dtype=torch.float64)
    hs = []
    for t in range(S):
        m_new = torch.maximum(logf[:, t] + m, logi[:, t])
        fw, iw = torch.exp(logf[:, t] + m - m_new), torch.exp(logi[:, t]
                                                              - m_new)
        c = c * fw[..., None, None] + iw[..., None, None] \
            * k[:, t, :, :, None] * v[:, t, :, None, :]
        n = n * fw[..., None] + iw[..., None] * k[:, t]
        den = torch.maximum((n * q[:, t]).sum(-1).abs(), torch.exp(-m_new))
        hs.append(torch.einsum("bhp,bhpr->bhr", q[:, t], c) / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1)


def test_float32_rounding_grows_with_the_chunk():
    """Why the on-card test holds chunks above 512 at 1e-3, not 5e-5: the
    float32 chunkwise form itself departs from a float64 evaluation as
    the chunk widens (the reference's cases stop at chunk 128)."""
    arrs = _t(_inputs(1, 2048, 1, 32, seed=2048 + 32))
    truth = _sequential_f64(*arrs)
    err = {c: float((mlstm_chunkwise(*arrs, c).double() - truth).abs().max())
           for c in (64, 2048)}
    assert err[64] <= ATOL
    assert ATOL < err[2048] <= 1e-3


def _bf16_inputs(B, S, H, P, seed):
    """q, k, v rounded to bf16 (the numbers both packages see) and the
    float32 gates."""
    q, k, v, logi, logf = _inputs(B, S, H, P, seed)
    qkv = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    return qkv + _t([logi, logf])


@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=lambda c: "B{}S{}H{}P{}C{}".format(*c))
def test_bf16_operand_plain_version_matches_reference(case):
    """The wgmma route's plain version (three operands rounded to bf16)
    against the Pallas kernel in interpret mode and the sequential oracle
    on the same bf16 numbers, at the port's bf16 tolerance."""
    B, S, H, P, chunk = case
    args = _bf16_inputs(B, S, H, P, seed=S + P)
    assert ops.route(torch.bfloat16, P, chunk) == "wgmma"
    got = mlstm_chunkwise(*args, chunk, operand_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    jx = [jnp.asarray(t.float().numpy()) for t in args]
    pallas = np.asarray(jax_mlstm_chunk(*jx, chunk=chunk))   # interpret mode
    oracle = np.asarray(jax_sequential(*jx))
    np.testing.assert_allclose(got.float().numpy(), pallas, **BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(), oracle, **BF16_TOL)
    # about one bf16 rounding from the float32 version
    f32 = mlstm_chunkwise(*args, chunk).float()
    rel = float((got.float() - f32).norm() / f32.norm())
    assert 0 < rel <= 1e-2


@pytest.mark.parametrize("case", MLSTM_CASES + WGMMA_CASES,
                         ids=lambda c: "B{}S{}H{}P{}C{}".format(*c))
def test_float32_operands_round_nothing(case):
    B, S, H, P, chunk = case
    arrs = _t(_inputs(B, S, H, P, seed=S * H + P))
    want = mlstm_chunkwise(*arrs, chunk)
    assert torch.equal(mlstm_chunkwise(*arrs, chunk,
                                       operand_dtype=torch.float32), want)
    assert not torch.equal(mlstm_chunkwise(*arrs, chunk,
                                           operand_dtype=torch.bfloat16),
                           want)


@pytest.mark.parametrize("case", MLSTM_CASES + WGMMA_CASES
                         + [(2, 300, 3, 16, 100), (1, 64, 1, 16, 64)],
                         ids=lambda c: "B{}S{}H{}P{}C{}".format(*c))
def test_gates_first_equal_the_chunk_walk(case):
    """The stabilisers from the gates alone (the wgmma kernel's first
    pass) equal, bit for bit, the terms ``mlstm_chunkwise`` carries chunk
    by chunk."""
    B, S, H, P, chunk = case
    q, k, v, logi, logf = _t(_inputs(B, S, H, P, seed=S + H))
    walk = []
    mlstm_chunkwise(q, k, v, logi, logf, chunk, record=walk)
    g = mlstm_gates(logi, logf, chunk)
    c = min(chunk, S)
    assert len(walk) == S // c
    for t, w in enumerate(walk):
        rows = slice(t * c, (t + 1) * c)
        for name, got, want in (
                ("m_prev", g.m_prev[:, t], w["m_prev"]),
                ("m_comb", g.m_comb[:, rows], w["m_comb"]),
                ("scale_in", g.scale_in[:, rows], w["scale_in"]),
                ("wk", g.wk[:, rows], w["wk"]),
                ("decay", g.decay[:, t], w["decay"])):
            assert torch.equal(got, want), (name, t)
    assert bool((g.scale_in[:, :c] == 0).all())      # no state before chunk 1
    assert bool((g.decay[:, 0] == 0).all())


@pytest.mark.parametrize("dtype,P,chunk,want", [
    (torch.bfloat16, 64, 128, "wgmma"), (torch.bfloat16, 1024, 1024, "wgmma"),
    (torch.bfloat16, 1024, 256, "wgmma"), (torch.bfloat16, 256, 512, "wgmma"),
    (torch.bfloat16, 32, 256, "fma"), (torch.bfloat16, 16, 128, "fma"),
    (torch.bfloat16, 64, 64, "fma"), (torch.bfloat16, 1024, 2048, "fma"),
    (torch.bfloat16, 128, 96, "fma"), (torch.bfloat16, 128, 16, "fma"),
    (torch.float32, 1024, 256, "fma"), (torch.float32, 64, 64, "fma"),
])
def test_route(dtype, P, chunk, want):
    assert ops.route(dtype, P, chunk) == want


@pytest.mark.parametrize("S,chunk,route", [(256, 128, "wgmma"),
                                           (128, 256, "wgmma"),
                                           (96, 256, "fma")])
def test_cpu_wrapper_computes_the_routes_plain_version(S, chunk, route):
    """On the CPU the wrapper returns the plain version of the route a
    CUDA call would take (the chunk in use is min(chunk, S)), and counts no
    launch."""
    args = _bf16_inputs(1, S, 2, 64, seed=S)
    c = min(chunk, S)
    assert ops.route(torch.bfloat16, 64, c) == route
    counts = (ops.launches, ops.launches_wgmma, ops.launches_fma)
    got = ops.mlstm_chunk(*args, chunk=chunk)
    want = mlstm_chunkwise(*args, c, operand_dtype=torch.bfloat16
                           if route == "wgmma" else None)
    assert torch.equal(got, want)
    assert torch.equal(ops.plain_version(*args, chunk), want)
    assert (ops.launches, ops.launches_wgmma, ops.launches_fma) == counts


def _two_chunks_by_hand(q, k, v, logi, logf, c, rounded):
    """Two chunks of the chunkwise form written out, rounding to bf16 only
    the operands named in ``rounded`` ("sw", "kwk", "state")."""
    def rnd(name, t):
        return t.bfloat16().float() if name in rounded else t
    qf, kf, vf = (t.float() for t in (q, k, v))
    g = mlstm_gates(logi, logf, c)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool))
    outs, c_prev, n_prev = [], None, None
    for t in range(2):
        rows = slice(t * c, (t + 1) * c)
        qi, ki, vi = qf[:, rows], kf[:, rows], vf[:, rows]
        cum, li = g.cum[:, rows], logi[:, rows]
        mc, sc, wk = g.m_comb[:, rows], g.scale_in[:, rows], g.wk[:, rows]
        d = cum[:, :, None, :] - cum[:, None, :, :] + li[:, None, :, :]
        w = torch.where(mask[None, :, :, None],
                        torch.exp(d - mc[:, :, None, :]), 0.0)
        sw = torch.einsum("bihp,bjhp->bijh", qi, ki) * w
        h = torch.einsum("bijh,bjhp->bihp", rnd("sw", sw), vi)
        den = sw.sum(2)
        if t:
            h = h + torch.einsum("bihp,bhpr->bihr", qi,
                                 rnd("state", c_prev)) * sc[..., None]
            den = den + sc * torch.einsum("bihp,bhp->bih", qi, n_prev)
        outs.append(h / torch.maximum(den.abs(), torch.exp(-mc))[..., None])
        c_prev = torch.einsum("bjhp,bjhr->bhpr",
                              rnd("kwk", ki * wk[..., None]), vi)
        n_prev = torch.einsum("bjhp,bjh->bhp", ki, wk)
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("dropped", [None, "sw", "kwk", "state"])
def test_bf16_operands_are_rounded_at_the_kernels_three_places(dropped):
    """The wgmma route's plain version rounds (q k^T) o W, k o wk and the
    carried state, and nothing else: a hand-written two-chunk version with
    those three roundings equals it to float32 summation order; leaving
    any one of them out moves the output by far more."""
    c = 128
    args = _bf16_inputs(1, 2 * c, 2, 64, seed=7)
    got = mlstm_chunkwise(*args, c, operand_dtype=torch.bfloat16).float()
    all3 = {"sw", "kwk", "state"}
    hand = _two_chunks_by_hand(*args, c, all3 - {dropped}).bfloat16().float()
    diff = float((got - hand).norm() / got.norm())
    if dropped is None:
        assert diff <= 1e-6
    else:       # one bf16 rounding of one term: 1.6e-4 (state) to 2.7e-3
        assert diff > 2e-5, dropped
