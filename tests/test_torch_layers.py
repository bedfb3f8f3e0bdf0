"""The port's model layers (rope, norms, MLP, attention, decode attention
and its caches) against the JAX reference, on the CPU.

Weights are made by the reference (``Model.init``) and carried across with
``Model.params_from_numpy``; inputs come from numpy seeds.  Tolerances:

* float32: atol/rtol 2e-5 — the same arithmetic, summed in another
  order by XLA and torch;
* bfloat16: 1e-2 to 3e-2 — one or two bf16 roundings (2^-8 relative) that
  the two frameworks place differently.

``attention_impl="flash"`` on CPU tensors runs the kernel's plain version
in the port and the chunked path in the reference (its off-TPU dispatch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import rotary as jrotary
from repro.runconfig import RunConfig as JRunConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, common, mlp, rotary
from repro_torch.runconfig import RunConfig


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _t(x):
    """A JAX array as a torch tensor of the same dtype (bf16 exactly)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections, pos3", [(None, False), ((2, 3, 3), False),
                                            ((2, 3, 3), True)],
                         ids=["rope", "mrope-text", "mrope-thw"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_rope_matches_reference(sections, pos3, dtype):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 9, 4, 16), np.float32)).astype(
        dtype)
    shape = (3, 2, 9) if pos3 else (2, 9)
    pos = rng.integers(0, 4096, size=shape).astype(np.int32)
    want = jrotary.apply_rope(x, jnp.asarray(pos), 1e6, sections)
    got = rotary.apply_rope(_t(x), torch.from_numpy(pos), 1e6, sections)
    tol = 2e-5 if dtype == jnp.float32 else 1e-2
    # angles reach 4096 rad: one f32 ulp of the angle is ~5e-4 rad there,
    # so f32 sin/cos of the same angle agree only to that
    np.testing.assert_allclose(_np(got), _np(want), atol=max(tol, 2e-3))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_norm_matches_reference(kind, dtype):
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((3, 7, 64), np.float32) * 3
                    ).astype(dtype)
    p = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 64), dtype),
         "bias": jnp.asarray(rng.standard_normal(64), dtype)}
    if kind == "rmsnorm":
        p.pop("bias")
    want = jcommon.norm_apply(p, x, kind=kind, eps=1e-5)
    got = common.norm_apply({k: _t(v) for k, v in p.items()}, _t(x),
                            kind=kind, eps=1e-5)
    assert got.dtype == _t(want).dtype
    tol = 2e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("act, reduce", [("silu", "float32"),
                                         ("gelu", "float32"),
                                         ("silu", "bfloat16")])
def test_mlp_matches_reference(act, reduce):
    jcfg = jax_smoke("qwen1.5-4b").scaled(act=act, mlp_bias=True)
    tcfg = get_smoke_config("qwen1.5-4b").scaled(act=act, mlp_bias=True)
    jp = jmlp.init(jax.random.key(1), jcfg, dtype=jnp.float32)
    jp = jax.tree.map(lambda a: a + 0.1, jp)        # non-zero biases
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (2, 5, jcfg.d_model), np.float32))
    want = jmlp.apply(jp, x, jcfg, JRunConfig(tp_reduce_dtype=reduce))
    got = mlp.apply(jax.tree.map(_t, jp), _t(x), tcfg,
                    RunConfig(tp_reduce_dtype=reduce))
    # the bf16 reduce path rounds each product to bf16 in both packages
    tol = 2e-5 if reduce == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("impl", ["reference", "chunked", "flash"])
@pytest.mark.parametrize("arch, window, softcap", [
    ("yi-6b", None, None), ("qwen1.5-4b", 5, None),
    ("mistral-nemo-12b", None, 20.0), ("qwen2-vl-72b", 6, 10.0)],
    ids=["yi", "qwen-window", "nemo-softcap", "vl-window-softcap"])
def test_attention_apply_matches_reference(impl, arch, window, softcap):
    jcfg = jax_smoke(arch).scaled(logit_softcap=softcap)
    tcfg = get_smoke_config(arch).scaled(logit_softcap=softcap)
    jp = jattn.init(jax.random.key(4), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 13, jcfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    kw = dict(attention_impl=impl, chunk_size_k=4, flash_block_k=8)
    want = jattn.apply(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                       JRunConfig(**kw), causal=True, window=window)
    got = attention.apply(jax.tree.map(_t, jp), torch.from_numpy(x),
                          torch.from_numpy(pos.copy()), tcfg,
                          RunConfig(**kw), causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_decode_apply_matches_reference(layout, cache_dtype):
    """One decode step at a per-slot position vector (slot 3 past the end
    of its cache: the insert clamps, as the reference's does)."""
    jcfg, tcfg = jax_smoke("yi-6b"), get_smoke_config("yi-6b")
    kw = dict(kv_layout=layout, kv_cache_dtype=cache_dtype)
    jrc, trc = JRunConfig(**kw), RunConfig(**kw)
    jp = jattn.init(jax.random.key(8), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(9)
    B, S_max, hd = 4, 12, jcfg.resolved_head_dim
    ck, cv = jattn.init_cache(B, S_max, jcfg, jrc)
    prefix = jnp.asarray(rng.standard_normal(
        (2, B, S_max, jcfg.n_kv_heads, hd), np.float32))
    ck = jattn.fill_cache(ck, prefix[0], jrc)
    cv = jattn.fill_cache(cv, prefix[1], jrc)
    x = rng.standard_normal((B, 1, jcfg.d_model), np.float32)
    pos = np.array([0, 5, 11, 14], np.int32)
    tk, tv = _t(ck), _t(cv)
    want, jk, jv = jattn.decode_apply(jp, jnp.asarray(x), ck, cv,
                                      jnp.asarray(pos), jcfg, jrc,
                                      window=None)
    got, gk, gv = attention.decode_apply(
        jax.tree.map(_t, jp), torch.from_numpy(x), tk, tv,
        torch.from_numpy(pos), tcfg, trc, window=None)
    assert gk is tk and gv is tv                 # updated in place
    tol = 2e-5 if cache_dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    if cache_dtype == "int8":
        np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(_np(gk), _np(jk), atol=tol)
        np.testing.assert_allclose(_np(gv), _np(jv), atol=tol)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_decode_apply_window(layout):
    jcfg, tcfg = jax_smoke("yi-6b"), get_smoke_config("yi-6b")
    kw = dict(kv_layout=layout, kv_cache_dtype="float32")
    jp = jattn.init(jax.random.key(10), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(11)
    ck, cv = jattn.init_cache(2, 16, jcfg, JRunConfig(**kw))
    ck = ck + jnp.asarray(rng.standard_normal(ck.shape, np.float32))
    cv = cv + jnp.asarray(rng.standard_normal(cv.shape, np.float32))
    x = rng.standard_normal((2, 1, jcfg.d_model), np.float32)
    pos = np.array([3, 12], np.int32)
    want, _, _ = jattn.decode_apply(jp, jnp.asarray(x), ck, cv,
                                    jnp.asarray(pos), jcfg,
                                    JRunConfig(**kw), window=4)
    got, _, _ = attention.decode_apply(
        jax.tree.map(_t, jp), torch.from_numpy(x), _t(ck), _t(cv),
        torch.from_numpy(pos), tcfg, RunConfig(**kw), window=4)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
