"""The port's mamba block (``repro_torch.models.ssm``, the chunked SSD)
against the JAX reference, on the CPU.

Weights are made by the reference (``ssm.init``, jamba's smoke config)
and carried across; inputs come from numpy seeds.  Tolerances: float32
atol/rtol 1e-4 — the same arithmetic, summed in another order; the
chunked form against the sequential oracle is the same sums regrouped by
chunk, held at the same bound.

Teacher-forced decode against the full-sequence pass in float32 is held at
atol/rtol 1e-2: both packages keep the conv tail in bf16 (``init_state``),
so every decode step reads its three previous conv inputs rounded to bf16
(2^-9 relative), where the sequence pass reads them in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.runconfig import RunConfig as JRunConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm, transformer
from repro_torch.models.common import tree_map
from repro_torch.runconfig import RunConfig

ARCH = "jamba-1.5-large-398b"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _setup(B=2, S=16, seed=0, dtype=jnp.float32, a_log=0.0):
    """Reference params (with ``a_log`` set: decays exp(-exp(a_log)·dt))
    and an input, in both packages."""
    jcfg = jax_smoke(ARCH)
    jp = jssm.init(jax.random.key(seed), jcfg, dtype)
    jp["a_log"] = jnp.full_like(jp["a_log"], a_log)
    u = np.random.default_rng(seed + 1).standard_normal(
        (B, S, jcfg.d_model), np.float32)
    uj = jnp.asarray(u).astype(dtype)
    return (jcfg, jp, uj, get_smoke_config(ARCH),
            tree_map(_t, jax.tree.map(np.asarray, jp)), _t(uj))


@pytest.mark.parametrize("a_log", [0.0, -2.0], ids=["fast", "slow"])
@pytest.mark.parametrize("chunk", [4, 8, 16], ids=["c4", "c8", "cS"])
def test_apply_matches_reference(chunk, a_log):
    jcfg, jp, uj, cfg, tp, ut = _setup(a_log=a_log)
    want = jssm.apply(jp, uj, jcfg, JRunConfig(ssm_chunk=chunk))
    got = ssm.apply(tp, ut, cfg, RunConfig(ssm_chunk=chunk))
    assert got.shape == ut.shape and got.dtype == ut.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("chunk", [4, 8, 16], ids=["c4", "c8", "cS"])
def test_apply_matches_both_sequential_oracles(chunk):
    jcfg, jp, uj, cfg, tp, ut = _setup(seed=2, a_log=-1.0)
    got = ssm.apply(tp, ut, cfg, RunConfig(ssm_chunk=chunk))
    mine = ssm.ssd_reference(tp, ut, cfg)
    theirs = jssm.ssd_reference(jp, uj, jcfg)
    np.testing.assert_allclose(_np(mine), _np(theirs), atol=1e-4, rtol=1e-4)
    for oracle in (mine, theirs):
        np.testing.assert_allclose(_np(got), _np(oracle), atol=1e-4,
                                   rtol=1e-4)


def test_bf16_apply_at_reference_tolerance():
    jcfg, jp, uj, cfg, tp, ut = _setup(dtype=jnp.bfloat16, seed=4)
    want = jssm.apply(jp, uj, jcfg, JRunConfig(ssm_chunk=8))
    got = ssm.apply(tp, ut, cfg, RunConfig(ssm_chunk=8))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=0.15, rtol=0.05)


def test_chunk_that_does_not_divide_s_is_refused():
    """Where the reference asserts ``S % c == 0``, the port raises
    ``ValueError``; a chunk longer than S is clamped to S in both."""
    jcfg, jp, uj, cfg, tp, ut = _setup(S=12)
    with pytest.raises(ValueError, match="ssm_chunk"):
        ssm.apply(tp, ut, cfg, RunConfig(ssm_chunk=8))
    with pytest.raises(AssertionError):
        jssm.apply(jp, uj, jcfg, JRunConfig(ssm_chunk=8))
    got = ssm.apply(tp, ut, cfg, RunConfig(ssm_chunk=64))
    want = jssm.apply(jp, uj, jcfg, JRunConfig(ssm_chunk=64))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_decode_step_matches_reference_and_updates_in_place():
    """Eight one-token steps from a zero state: outputs and states against
    the reference's ``decode_step``; the port's state is the one it was
    given, updated in place."""
    jcfg, jp, uj, cfg, tp, ut = _setup(S=8, seed=5, a_log=-1.0)
    jst = jssm.init_state(2, jcfg)
    st = ssm.init_state(2, cfg)
    for t in range(8):
        want, jst = jssm.decode_step(jp, uj[:, t:t + 1], jst, jcfg,
                                     JRunConfig())
        got, st2 = ssm.decode_step(tp, ut[:, t:t + 1], st, cfg, RunConfig())
        assert st2 is st
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(_np(st.s), _np(jst.s), atol=1e-4, rtol=1e-4)
    assert st.conv.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(st.conv), _np(jst.conv))


def test_decode_step_over_eight_tokens_matches_apply():
    jcfg, jp, uj, cfg, tp, ut = _setup(S=8, seed=6, a_log=-1.0)
    full = ssm.apply(tp, ut, cfg, RunConfig(ssm_chunk=4))
    st = ssm.init_state(2, cfg)
    outs = [ssm.decode_step(tp, ut[:, t:t + 1], st, cfg, RunConfig())[0]
            for t in range(8)]
    np.testing.assert_allclose(_np(torch.cat(outs, dim=1)), _np(full),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("S", [8, 13])
def test_final_state_matches_reference(S):
    """``_ssm_final_state`` (the carried state from one product over S, the
    bf16 conv tail) against the reference's, and against the state the
    chunked pass carries (the last step of ``decode_step`` from it)."""
    jcfg, jp, uj, cfg, tp, ut = _setup(S=S, seed=7, a_log=-0.5)
    want = jtf._ssm_final_state(jp, uj, jcfg, JRunConfig())
    got = transformer._ssm_final_state(tp, ut, cfg, RunConfig())
    np.testing.assert_allclose(_np(got.s), _np(want.s), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(_np(got.conv), _np(want.conv))
    st = ssm.init_state(2, cfg)
    for t in range(S):
        ssm.decode_step(tp, ut[:, t:t + 1], st, cfg, RunConfig())
    # decode reads its conv inputs through the bf16 tail (module docstring)
    np.testing.assert_allclose(_np(got.s), _np(st.s), atol=1e-2, rtol=1e-2)


def test_init_matches_reference_tree():
    jcfg = jax_smoke(ARCH)
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        jax.eval_shape(lambda: jssm.init(
                            jax.random.key(0), jcfg, jnp.bfloat16)))
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                   ssm.init(torch.Generator().manual_seed(0),
                            get_smoke_config(ARCH)))
    assert got == want
    assert ssm.dims(get_smoke_config(ARCH)) == jssm.dims(jcfg)
