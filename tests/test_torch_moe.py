"""The port's MoE MLP (``repro_torch.models.moe``) against the JAX
reference, on the CPU.

Weights are made by the reference (``moe.init``) and carried across; inputs
come from numpy seeds.  Tolerances:

* float32: atol/rtol 1e-4 — the same arithmetic, summed in another order
  (the dense path contracts (e, f) in one product in both packages);
* bfloat16: the reference's bf16 tolerance (atol 0.15, rtol 0.05,
  ``tests/test_arch_smoke.py``): bf16 rounds at other places in the two
  frameworks.

The router runs in float32 in both, so the top-k choices are the same;
ties go to the lower expert index (``jax.lax.top_k``'s order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jmoe
from repro.runconfig import RunConfig as JRunConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import moe
from repro_torch.models.common import tree_map
from repro_torch.runconfig import RunConfig

ARCHS = ["qwen2-moe-a2.7b", "jamba-1.5-large-398b", "grok-1-314b"]
TOL = {jnp.float32: (1e-4, 1e-4), jnp.bfloat16: (0.15, 0.05)}


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


def _setup(arch, dtype=jnp.float32, B=2, S=5, seed=0):
    jcfg = jax_smoke(arch)
    jp = jmoe.init(jax.random.key(seed), jcfg, dtype)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, jcfg.d_model), np.float32)
    xj = jnp.asarray(x).astype(dtype)
    return jcfg, jp, xj, get_smoke_config(arch), tree_map(
        _t, jax.tree.map(np.asarray, jp)), _t(xj)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("impl", ["dense", "dropping"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_reference(arch, impl, dtype):
    jcfg, jp, xj, cfg, tp, xt = _setup(arch, dtype)
    want, jaux = jmoe.apply(jp, xj, jcfg, JRunConfig(moe_impl=impl))
    got, aux = moe.apply(tp, xt, cfg, RunConfig(moe_impl=impl))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)
    # the aux loss is float32 in both: routing is the same function
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_reference(arch):
    jcfg, jp, xj, cfg, tp, xt = _setup(arch, S=9)
    xt2, xj2 = xt.reshape(-1, cfg.d_model), xj.reshape(-1, jcfg.d_model)
    w, aux, topi, topv = moe._routing(tp, xt2, cfg)
    jw, jaux, jtopi, jtopv = jmoe._routing(jp, xj2, jcfg)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    np.testing.assert_allclose(topv.numpy(), np.asarray(jtopv), atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_top_k_ties_go_to_the_lower_index():
    """A router whose columns are equal gives every expert the same
    probability: the reference's ``lax.top_k`` picks experts 0..K-1, and so
    must the port (a stable descending sort).  Then a tie across the k-th
    place: experts 5 and 2 share the second-largest logit."""
    jcfg, jp, xj, cfg, tp, xt = _setup("qwen2-moe-a2.7b", S=4)
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    x2 = xt.reshape(-1, cfg.d_model)
    col = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (cfg.d_model, 1), np.float32))
    for w, want_first in ((col.repeat(1, E), list(range(K))),
                          (None, [0, 2])):
        if w is None:               # logits = x·w: 3 for e=0, 2 for 2, 5
            x2 = torch.ones((3, cfg.d_model))
            w = torch.zeros((cfg.d_model, E))
            w[0, 0], w[0, 2], w[0, 5] = 3.0, 2.0, 2.0
        tp_tie = dict(tp, router={"w": w})
        jp_tie = dict(jp, router={"w": jnp.asarray(w.numpy())})
        _, _, topi, _ = moe._routing(tp_tie, x2, cfg)
        _, _, jtopi, _ = jmoe._routing(jp_tie, jnp.asarray(x2.numpy()), jcfg)
        np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
        assert topi[:, :len(want_first)].tolist() == \
            [want_first] * topi.shape[0]


def test_capacity_at_decode_is_one():
    """``max(1, int(cf·T·K/E))`` at a two-token decode step: qwen2-moe's
    60 experts top-4 give int(1.25·2·4/60) = 0, so one slot each."""
    cfg = get_config("qwen2-moe-a2.7b")
    assert moe._capacity(2, cfg, RunConfig()) == 1
    assert moe._capacity(8192, cfg, RunConfig()) == int(1.25 * 8192 * 4 / 60)
    assert moe._capacity(8192, cfg, RunConfig(moe_capacity_factor=15.0)) \
        == 8192


@pytest.mark.parametrize("arch", ARCHS)
def test_dropping_at_decode_matches_reference(arch):
    """T = 2 tokens, capacity 1: the second token routed to an expert the
    first also took is dropped, in both packages alike."""
    jcfg, jp, xj, cfg, tp, xt = _setup(arch, B=2, S=1, seed=3)
    assert moe._capacity(2, cfg, RunConfig()) == 1
    rc = dict(moe_impl="dropping")
    want, _ = jmoe.apply(jp, xj, jcfg, JRunConfig(**rc))
    got, _ = moe.apply(tp, xt, cfg, RunConfig(**rc))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_dropping_at_full_capacity_equals_dense(arch):
    """At ``moe_capacity_factor = E/K`` the capacity is T and no token is
    dropped: the dispatch computes the dense path's function."""
    jcfg, jp, xj, cfg, tp, xt = _setup(arch, S=7)
    cf = cfg.n_experts / cfg.n_experts_per_tok
    dense, _ = moe.apply(tp, xt, cfg, RunConfig())
    drop, _ = moe.apply(tp, xt, cfg, RunConfig(moe_impl="dropping",
                                               moe_capacity_factor=cf))
    np.testing.assert_allclose(drop.numpy(), dense.numpy(), atol=1e-4,
                               rtol=1e-4)
    want, _ = jmoe.apply(jp, xj, jcfg, JRunConfig(moe_impl="dropping",
                                                  moe_capacity_factor=cf))
    np.testing.assert_allclose(drop.numpy(), _np(want), atol=1e-4, rtol=1e-4)


def test_dropping_drops_the_overflow_as_the_reference():
    """At factor 0.5 (8 slots for 16 routed pairs per expert on average)
    (token, expert) pairs overflow: the output departs from dense, the
    same way in both packages."""
    jcfg, jp, xj, cfg, tp, xt = _setup("grok-1-314b", S=16, seed=5)
    rc = dict(moe_impl="dropping", moe_capacity_factor=0.5)
    dense, _ = moe.apply(tp, xt, cfg, RunConfig())
    drop, _ = moe.apply(tp, xt, cfg, RunConfig(**rc))
    assert not np.allclose(drop.numpy(), dense.numpy(), atol=1e-3)
    want, _ = jmoe.apply(jp, xj, jcfg, JRunConfig(**rc))
    np.testing.assert_allclose(drop.numpy(), _np(want), atol=1e-4, rtol=1e-4)


def test_init_matches_reference_tree():
    for arch in ARCHS:
        jcfg = jax_smoke(arch)
        want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                            jax.eval_shape(lambda: jmoe.init(
                                jax.random.key(0), jcfg, jnp.bfloat16)))
        gen = torch.Generator().manual_seed(0)
        got = tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                       moe.init(gen, get_smoke_config(arch)))
        assert got == want, arch
