"""The port's ``mlstm_chunk`` wrapper against the JAX reference.

On CPU tensors the wrapper computes its plain-torch version
(``ref.mlstm_chunkwise``).  It is held against the reference's Pallas
kernel run in interpret mode (as ``tests/test_kernels.py`` runs it) and
against the sequential oracle of both packages over the reference's
``MLSTM_CASES`` at the reference's atol 5e-5; chunk invariance within
2e-4; and the reference's kernel-to-model-path check at atol 5e-4.  The
CUDA kernel itself is held against the plain versions on the card by
``test_torch_mlstm_chunk_cuda.py`` and ``chip_smoke.py``.
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
                                                 mlstm_sequential)
from repro_torch.models import xlstm
from repro_torch.runconfig import RunConfig

# the reference's MLSTM_CASES (tests/test_kernels.py): (B, S, H, P, chunk)
MLSTM_CASES = [
    (2, 128, 2, 32, 32), (1, 256, 4, 64, 64), (2, 64, 1, 16, 16),
    (1, 512, 2, 32, 128), (1, 128, 2, 32, 128),
]
ATOL = 5e-5


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
