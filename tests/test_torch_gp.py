"""The port's single-task GP (§3.4) against the JAX reference.

Inputs come from a numpy seed.  Posteriors are compared two ways:

* carried across: the reference's fitted ``GPState`` is rebuilt in torch
  with ``gp.state_from_numpy``, so only the float order of the predict /
  select arithmetic differs — mean and std agree to 1e-4, and the q-EI
  picks must be array-equal on the ``tests/test_gp_select_batch.py``
  cases;
* fitted separately: both packages run their own Adam loop from the same
  init.  Each Adam step rounds differently (XLA vs torch reductions,
  LAPACK vs XLA Cholesky), and the drift compounds over the steps, so the
  fitted log-hyperparameters agree to 5e-3 after 40 steps.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import gp as rgp
from repro_torch.core import gp

POST_TOL = 1e-4
PARAM_ATOL = 5e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=30, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d))
    y = (np.sin(3 * x[:, 0]) + (x[:, 1] - 0.4) ** 2
         + 0.1 * rng.normal(size=n))
    return x, y


def _carry(st):
    """The reference's GPState, rebuilt on the CPU in torch."""
    return gp.state_from_numpy(
        {k: np.asarray(v) for k, v in st.params._asdict().items()},
        *(np.asarray(f) for f in st[1:]), device="cpu")


def test_state_from_numpy_roundtrip():
    x, y = _data(12, 2, seed=1)
    st = rgp.fit(x, y, steps=5, pad_to=16)
    pst = _carry(st)
    for a, b in zip(pst[1:], st[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert gp.params_to_dict(pst.params) == rgp.params_to_dict(st.params)
    back = gp.params_from_dict(json.loads(json.dumps(
        rgp.params_to_dict(st.params))), device="cpu")
    assert gp.params_to_dict(back) == rgp.params_to_dict(st.params)


@pytest.mark.parametrize("kind", ["matern52", "rbf"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_predict_matches_reference(kind, use_kernel):
    x, y = _data(26, 3, seed=2)
    st = rgp.fit(x, y, kind=kind, steps=30, pad_to=32)
    q = np.random.default_rng(3).random((40, 3)).astype(np.float32)
    mu, sd = gp.predict(_carry(st), q, kind=kind, use_kernel=use_kernel)
    rmu, rsd = rgp.predict(st, q, kind=kind)
    np.testing.assert_allclose(mu.numpy(), np.asarray(rmu), atol=POST_TOL)
    np.testing.assert_allclose(sd.numpy(), np.asarray(rsd), atol=POST_TOL)
    ei = gp.expected_improvement(_carry(st), q, float(np.min(y)), kind)
    rei = rgp.expected_improvement(st, q, float(np.min(y)), kind)
    np.testing.assert_allclose(ei.numpy(), np.asarray(rei), atol=POST_TOL)
    np.testing.assert_allclose(gp.ucb(_carry(st), q, kind).numpy(),
                               np.asarray(rgp.ucb(st, q, kind)),
                               atol=POST_TOL)


@pytest.mark.parametrize("pad", [True, False])
def test_condition_matches_reference(pad):
    """Fixed hyperparameters: one Cholesky build in each package."""
    x, y = _data(20, 2, seed=4)
    params = rgp.fit(x, y, steps=20, pad=False).params
    rst = rgp.condition(params, x, y, pad=pad)
    pst = gp.condition(_carry(rst).params, x, y, pad=pad, device="cpu")
    for a, b in zip(pst[1:], rst[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_fit_matches_reference():
    x, y = _data(30, 3, seed=5)
    st = rgp.fit(x, y, steps=40, pad_to=32)
    pst = gp.fit(x, y, steps=40, pad_to=32, device="cpu")
    for f in gp.GPParams._fields:
        np.testing.assert_allclose(getattr(pst.params, f).numpy(),
                                   np.asarray(getattr(st.params, f)),
                                   atol=PARAM_ATOL)
    q = np.random.default_rng(6).random((20, 3)).astype(np.float32)
    mu, sd = gp.predict(pst, q)
    rmu, rsd = rgp.predict(st, q)
    np.testing.assert_allclose(mu.numpy(), np.asarray(rmu), atol=1e-2)
    np.testing.assert_allclose(sd.numpy(), np.asarray(rsd), atol=1e-2)


def test_fit_with_obs_var_and_warm_start():
    x, y = _data(18, 2, seed=7)
    var = np.random.default_rng(8).uniform(0, 0.01, 18)
    st = rgp.fit(x, y, steps=15, obs_var=var, pad_to=32)
    pst = gp.fit(x, y, steps=15, obs_var=var, pad_to=32, device="cpu")
    np.testing.assert_allclose(pst.params.log_noise_var.numpy(),
                               np.asarray(st.params.log_noise_var),
                               atol=PARAM_ATOL)
    warm = gp.fit(x, y, steps=0, params=_carry(st).params, obs_var=var,
                  pad_to=32, device="cpu")
    np.testing.assert_allclose(warm.chol.numpy(), np.asarray(st.chol),
                               atol=1e-4)


def test_non_pd_cholesky_is_nan_not_an_error():
    """``jnp.linalg.cholesky`` returns NaNs on a matrix that is not PD and
    the Adam loop's nan_to_num relies on it; the port matches."""
    k = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    want = np.asarray(rgp.jnp.linalg.cholesky(k.numpy()))
    got = gp._cholesky(k).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[np.tril_indices(2)]).all()
    assert np.triu(got, 1).sum() == 0
    ok = gp._cholesky(torch.eye(2))
    assert torch.equal(ok, torch.eye(2))


def test_chol_append_matches_reference():
    x, _ = _data(24, 3, seed=9)
    params = rgp.init_params(3)
    ls = np.exp(np.asarray(params.log_lengthscale))
    k = np.asarray(rgp.matern52(x.astype(np.float32), x.astype(np.float32),
                                ls, 1.0))
    kn = (k + 0.0102 * np.eye(24)).astype(np.float32)
    head = np.linalg.cholesky(kn[:23, :23].astype(np.float64)).astype(
        np.float32)
    l, d = gp.chol_append(torch.from_numpy(head), torch.from_numpy(kn[23, :23]),
                          torch.tensor(kn[23, 23]))
    rl, rd = rgp.chol_append(head, kn[23, :23], float(kn[23, 23]))
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), atol=1e-5)
    assert float(d) == pytest.approx(float(rd), abs=1e-5)


# ---------------------------------------------------------------------------
# q-EI selection: the tests/test_gp_select_batch.py cases, state carried
# ---------------------------------------------------------------------------

def _picks(st, cand, y, q, use_kernel=False, **kw):
    n = len(y)
    y_raw = np.zeros(int(st.x.shape[0]), np.float32)
    y_raw[:n] = np.asarray(y, np.float32)
    best = float(np.min(y))
    want = np.asarray(rgp.select_batch(st, cand.astype(np.float32), y_raw, n,
                                       best, q, **kw))
    got = gp.select_batch(_carry(st), cand.astype(np.float32), y_raw, n,
                          best, q, use_kernel=use_kernel, **kw).numpy()
    return got, want


@pytest.mark.parametrize("fantasy", ["liar", "believer"])
@pytest.mark.parametrize("q", [1, 4])
def test_select_batch_picks_equal(fantasy, q):
    x, y = _data(30, 3, seed=4)
    st = rgp.fit(x, y, steps=40, pad_to=rgp._bucket(30 + q))
    cand = np.random.default_rng(5).random((200, 3))
    got, want = _picks(st, cand, y, q, fantasy=fantasy)
    assert len(set(got.tolist())) == q
    np.testing.assert_array_equal(got, want)


def test_select_batch_ucb_picks_equal():
    x, y = _data(26, 2, seed=6)
    st = rgp.fit(x, y, steps=30, pad_to=rgp._bucket(26 + 3))
    cand = np.random.default_rng(7).random((150, 2))
    got, want = _picks(st, cand, y, 3, acquisition="ucb")
    np.testing.assert_array_equal(got, want)


def test_select_batch_unpadded_picks_equal():
    x, y = _data(20, 2, seed=8)
    st = rgp.fit(x, y, steps=30, pad=False)
    cand = np.random.default_rng(9).random((80, 2))
    got, want = _picks(st, cand, y, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", [2, 8])
def test_select_batch_kernel_route_picks_equal(q):
    """``use_kernel`` (the plain version on CPU tensors) at a pool that
    mixes LHS, a local ball and axis sweeps, as BOStrategy builds it."""
    x, y = _data(40, 4, seed=10)
    st = rgp.fit(x, y, steps=30, pad_to=48)
    rng = np.random.default_rng(11)
    inc = x[np.argmin(y)]
    local = np.clip(inc + rng.normal(0, 0.08, (32, 4)), 0, 1)
    sweeps = np.repeat(inc[None], 20, 0)
    sweeps[np.arange(20), np.arange(20) % 4] = np.tile(
        [0.0, 0.25, 0.5, 0.75, 1.0], 4)
    cand = np.vstack([rng.random((128, 4)), local, sweeps])
    got, want = _picks(st, cand, y, q, use_kernel=True)
    np.testing.assert_array_equal(got, want)
