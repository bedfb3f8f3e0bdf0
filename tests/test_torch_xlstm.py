"""The port's xLSTM layers (``repro_torch.models.xlstm``) against the JAX
reference, on the CPU, at the smoke config (d_model 64, 2 heads, P 64).

Parameters are made by the reference and carried across; inputs come from
numpy seeds.  Everything is float32, and the tolerance is atol/rtol 1e-4:
the same arithmetic summed in another order (the mLSTM sequence pass is the
chunkwise kernel's plain version here, the reference's jnp scan there).
The port's decode steps update the state they are given in place; the
tests check that too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as jtf
from repro.models import xlstm as jx
from repro.runconfig import RunConfig as JRunConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer, xlstm
from repro_torch.runconfig import RunConfig

TOL = dict(atol=1e-4, rtol=1e-4)
CHUNK = 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfgs():
    return jax_smoke("xlstm-1.3b"), get_smoke_config("xlstm-1.3b")


def _params(init, jcfg, seed=0):
    jp = init(jax.random.key(seed), jcfg, jnp.float32)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _u(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _state_close(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def test_dims_and_param_layout(cfgs):
    jcfg, cfg = cfgs
    assert xlstm.mlstm_dims(cfg) == jx.mlstm_dims(jcfg)
    gen = torch.Generator().manual_seed(0)
    for init, jinit in ((xlstm.mlstm_init, jx.mlstm_init),
                        (xlstm.slstm_init, jx.slstm_init)):
        want = jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype)),
            jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.key(0)))
        got = init(gen, cfg)
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).split(".")[-1]), got)
        assert got == want


def test_init_states_match_reference(cfgs):
    jcfg, cfg = cfgs
    _state_close(xlstm.mlstm_init_state(3, cfg, device="cpu"),
                 jx.mlstm_init_state(3, jcfg))
    _state_close(xlstm.slstm_init_state(3, cfg, device="cpu"),
                 jx.slstm_init_state(3, jcfg))


@pytest.mark.parametrize("S", [CHUNK, 4 * CHUNK], ids=["one-chunk",
                                                       "four-chunks"])
def test_mlstm_apply_matches_reference(cfgs, S):
    jcfg, cfg = cfgs
    jp, tp = _params(jx.mlstm_init, jcfg)
    u = _u(cfg, 2, S, seed=1)
    want = jx.mlstm_apply(jp, jnp.asarray(u), jcfg,
                          JRunConfig(mlstm_chunk=CHUNK))
    got = xlstm.mlstm_apply(tp, torch.from_numpy(u), cfg,
                            RunConfig(mlstm_chunk=CHUNK))
    _close(got, want)


def test_mlstm_reference_matches_reference(cfgs):
    jcfg, cfg = cfgs
    jp, tp = _params(jx.mlstm_init, jcfg)
    u = _u(cfg, 2, 24, seed=2)
    _close(xlstm.mlstm_reference(tp, torch.from_numpy(u), cfg),
           jx.mlstm_reference(jp, jnp.asarray(u), jcfg))


def test_mlstm_decode_step_matches_reference_in_place(cfgs):
    jcfg, cfg = cfgs
    jp, tp = _params(jx.mlstm_init, jcfg)
    u = _u(cfg, 2, 5, seed=3)
    jst = jx.mlstm_init_state(2, jcfg)
    tst = xlstm.mlstm_init_state(2, cfg, device="cpu")
    bufs = tuple(tst)
    for t in range(5):
        want, jst = jx.mlstm_decode_step(jp, jnp.asarray(u[:, t:t + 1]), jst,
                                         jcfg, JRunConfig())
        got, tst = xlstm.mlstm_decode_step(tp, torch.from_numpy(
            u[:, t:t + 1]), tst, cfg, RunConfig())
        _close(got, want)
        _state_close(tst, jst)
    assert all(a is b for a, b in zip(tst, bufs))


def test_slstm_apply_matches_reference(cfgs):
    jcfg, cfg = cfgs
    jp, tp = _params(jx.slstm_init, jcfg)
    # non-zero recurrent bias too, so every term of the cell is exercised
    b = np.random.default_rng(9).standard_normal(
        np.asarray(jp["bias"]).shape, dtype=np.float32) * 0.3
    jp["bias"], tp["bias"] = jnp.asarray(b), torch.from_numpy(b)
    u = _u(cfg, 2, 16, seed=4)
    _close(xlstm.slstm_apply(tp, torch.from_numpy(u), cfg, RunConfig()),
           jx.slstm_apply(jp, jnp.asarray(u), jcfg, JRunConfig()))


def test_slstm_decode_step_matches_reference_in_place(cfgs):
    jcfg, cfg = cfgs
    jp, tp = _params(jx.slstm_init, jcfg)
    u = _u(cfg, 2, 5, seed=5)
    jst = jx.slstm_init_state(2, jcfg)
    tst = xlstm.slstm_init_state(2, cfg, device="cpu")
    bufs = tuple(tst)
    for t in range(5):
        want, jst = jx.slstm_decode_step(jp, jnp.asarray(u[:, t:t + 1]), jst,
                                         jcfg, JRunConfig())
        got, tst = xlstm.slstm_decode_step(tp, torch.from_numpy(
            u[:, t:t + 1]), tst, cfg, RunConfig())
        _close(got, want)
        _state_close(tst, jst)
    assert all(a is b for a, b in zip(tst, bufs))


def test_mlstm_final_state_matches_reference(cfgs):
    jcfg, cfg = cfgs
    jp, tp = _params(jx.mlstm_init, jcfg)
    u = _u(cfg, 2, 24, seed=6)
    want = jtf._mlstm_final_state(jp, jnp.asarray(u), jcfg)
    ut = torch.from_numpy(u)
    _state_close(transformer._mlstm_final_state(tp, ut, cfg), want)
    qkvg = xlstm._mlstm_qkvg(tp, ut, cfg)         # shared, as in prefill
    _state_close(transformer._mlstm_final_state(tp, ut, cfg, qkvg), want)


def test_mlstm_final_state_is_the_sequential_state(cfgs):
    """The prefill's one-product state == the state after stepping the
    recurrence token by token."""
    jcfg, cfg = cfgs
    _, tp = _params(jx.mlstm_init, jcfg, seed=1)
    u = torch.from_numpy(_u(cfg, 2, 12, seed=7))
    st = xlstm.mlstm_init_state(2, cfg, device="cpu")
    for t in range(12):
        _, st = xlstm.mlstm_decode_step(tp, u[:, t:t + 1], st, cfg,
                                        RunConfig())
    _state_close(transformer._mlstm_final_state(tp, u, cfg),
                 jx.MlstmState(*(a.numpy() for a in st)))
