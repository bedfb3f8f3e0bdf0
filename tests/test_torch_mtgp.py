"""The port's multi-task GP (intrinsic coregionalization, rank-1 plus
diagonal task covariance) against the JAX reference.

Inputs come from a numpy seed: stacked per-task observations of one
landscape at shifted levels, with measurement noise, as a transfer
corpus stacks sibling workloads.  Compared:

* fitted separately: each package runs its own Adam loop from the same
  init; the six fitted fields agree to ``PARAM_ATOL`` = 5e-3 after 40
  steps (the single-task tolerance of ``tests/test_torch_gp.py``);
* carried across: the reference's ``MTGPState`` rebuilt in torch
  (``gp.mt_state_from_numpy``) predicts each task and the stacked prior
  (``task=None``) within rtol 1e-5 / atol 1e-6;
* the gradient of the plain ``mt_neg_log_marginal`` (autograd through
  the plain Matérn) within relative L2 1e-4 of ``jax.grad`` of the
  reference's, field by field (the convention of
  ``tests/test_torch_gp_gram.py``);
* ``fit(tasks=<one task>)`` bit-equal to the single-task fit.

On CPU tensors the Gram wrappers compute the plain version, so
``use_kernel`` runs the same numbers here; ``test_torch_gp_cuda.py``
holds the kernel route on the card.  The reference's own multi-task
cases follow, run through the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp as rgp
from repro_torch.core import gp

PARAM_ATOL = 5e-3
PRED_RTOL, PRED_ATOL = 1e-5, 1e-6
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacked(seed=0, n=14, d=3, n_tasks=2, obs_var=False):
    """(x, y, tasks, var): ``n`` rows per task, each task at its own
    points, the landscape shifted by 0.5 per task, noise 0.05."""
    rng = np.random.default_rng(seed)
    xs, ys, ts = [], [], []
    for t in range(n_tasks):
        x = rng.random((n, d))
        xs.append(x)
        ys.append(np.sin(3 * x[:, 0]) + (x[:, 1] - 0.4) ** 2 + 0.5 * t
                  + 0.05 * rng.normal(size=n))
        ts.append(np.full(n, t, np.int32))
    var = rng.uniform(0, 0.01, n * n_tasks) if obs_var else None
    return np.vstack(xs), np.concatenate(ys), np.concatenate(ts), var


def _carry(st):
    """The reference's MTGPState, rebuilt on the CPU in torch."""
    return gp.mt_state_from_numpy(
        {k: np.asarray(v) for k, v in st.params._asdict().items()},
        *(np.asarray(f) for f in st[1:]), device="cpu")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("seed,n_tasks,obs_var", [(0, 2, False),
                                                  (1, 3, True)])
def test_fit_multitask_matches_reference(seed, n_tasks, obs_var,
                                         use_kernel):
    x, y, t, var = _stacked(seed, n_tasks=n_tasks, obs_var=obs_var)
    st = gp.fit_multitask(x, y, t, steps=40, obs_var=var,
                          use_kernel=use_kernel, device="cpu")
    rst = rgp.fit_multitask(x, y, t, steps=40, obs_var=var)
    for name, a, b in zip(gp.MTGPParams._fields, st.params, rst.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    np.testing.assert_array_equal(st.tasks.numpy(), np.asarray(rst.tasks))
    np.testing.assert_array_equal(st.y.numpy(), np.asarray(rst.y))
    assert float(st.y_std) == float(rst.y_std)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("task", [None, 0, 1])
def test_predict_multitask_carried_matches_reference(task, use_kernel):
    x, y, t, var = _stacked(2, obs_var=True)
    rst = rgp.fit_multitask(x, y, t, steps=30, obs_var=var)
    xq = np.random.default_rng(5).random((40, 3)).astype(np.float32)
    mu, sd = gp.predict_multitask(_carry(rst), xq, task=task,
                                  use_kernel=use_kernel)
    rmu, rsd = rgp.predict_multitask(rst, xq, task=task)
    np.testing.assert_allclose(mu.numpy(), np.asarray(rmu), rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    np.testing.assert_allclose(sd.numpy(), np.asarray(rsd), rtol=PRED_RTOL,
                               atol=PRED_ATOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_plain_gradient_matches_jax_grad(use_kernel):
    x, y, t, var = _stacked(3, n_tasks=3, obs_var=True)
    x32 = x.astype(np.float32)
    ys = ((y - y.mean()) / y.std()).astype(np.float32)
    extra = var.astype(np.float32)
    rng = np.random.default_rng(4)
    rp = rgp.MTGPParams(
        log_lengthscale=jnp.asarray(rng.uniform(-1.5, 0.5, 3), jnp.float32),
        log_signal_var=jnp.asarray(0.3, jnp.float32),
        log_noise_var=jnp.asarray(-3.0, jnp.float32),
        task_w=jnp.asarray(rng.uniform(0.5, 1.5, 3), jnp.float32),
        log_task_kappa=jnp.asarray(rng.uniform(-3, -1, 3), jnp.float32),
        task_offset=jnp.asarray(rng.uniform(-0.5, 0.5, 3), jnp.float32))
    want = jax.grad(lambda p: rgp.mt_neg_log_marginal(
        p, jnp.asarray(x32), jnp.asarray(t), jnp.asarray(ys), "matern52",
        jnp.asarray(extra)))(rp)
    pp = gp.mt_params_from_numpy(
        {k: np.asarray(v) for k, v in rp._asdict().items()}, device="cpu")
    leaf = gp._mt_flat(pp).requires_grad_(True)
    loss = gp.mt_neg_log_marginal(
        gp._mt_unflat(leaf, 3), torch.tensor(x32),
        torch.tensor(t.astype(np.int64)), torch.tensor(ys), "matern52",
        torch.tensor(extra), use_kernel)
    (g,) = torch.autograd.grad(loss, [leaf])
    for name, a, b in zip(gp.MTGPParams._fields, gp._mt_unflat(g, 3), want):
        a, b = a.double().reshape(-1), torch.tensor(np.asarray(b)).double()
        rel = float((a - b.reshape(-1)).norm() / b.norm())
        assert rel <= GRAD_REL, (name, rel)


@pytest.mark.parametrize("pad,obs_var", [(False, False), (True, True)])
def test_fit_with_one_task_is_the_single_task_fit(pad, obs_var):
    x, y, _, var = _stacked(6, n_tasks=1, obs_var=obs_var)
    plain = gp.fit(x, y, steps=25, pad=pad, obs_var=var, device="cpu")
    tasked = gp.fit(x, y, steps=25, pad=pad, obs_var=var, device="cpu",
                    tasks=np.zeros(len(y), np.int32))
    assert type(tasked) is gp.GPState
    for a, b in zip(tasked.params, plain.params):
        assert torch.equal(a, b)
    for a, b in zip(tasked[1:], plain[1:]):
        assert torch.equal(a, b)


def test_mt_fit_is_its_adam_steps():
    """``_mt_fit`` is :func:`gp._adam_update` over the flat layout
    ``[d + 2 + 3T]`` with the reference's boxes, bit for bit."""
    x, y, t, var = _stacked(7, n_tasks=3, obs_var=True)
    st = gp.fit_multitask(x, y, t, steps=0, obs_var=var, device="cpu")
    extra = torch.tensor((var.astype(np.float32)
                          / np.float32(st.y_std) ** 2).astype(np.float32))
    got = gp._mt_fit(st.params, st.x, st.tasks, st.y, "matern52", steps=12,
                     extra_noise=extra)
    p = gp._mt_flat(st.params)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    step = torch.zeros((1,), dtype=torch.int64)
    table = torch.tensor(gp._bias_table(12))
    bounds = gp._mt_box_bounds(3, 3, "cpu")
    for _ in range(12):
        gp._adam_update(p, m, v, step, table, bounds, lambda leaf: (
            gp.mt_neg_log_marginal(gp._mt_unflat(leaf, 3), st.x, st.tasks,
                                   st.y, "matern52", extra)), 0.05)
    for a, b in zip(got, gp._mt_unflat(p, 3)):
        assert torch.equal(a, b)
    lo, hi = bounds
    np.testing.assert_allclose(
        lo.numpy(), [np.log(1e-2)] * 3 + [np.log(1e-2), np.log(1e-4)]
        + [-3.0] * 3 + [np.log(1e-4)] * 3 + [-5.0] * 3, rtol=1e-6)
    np.testing.assert_allclose(
        hi.numpy(), [np.log(3.0)] * 3 + [np.log(1e2), 0.0]
        + [3.0] * 3 + [np.log(10.0)] * 3 + [5.0] * 3, rtol=1e-6)


def test_state_and_params_carry_across_packages():
    x, y, t, _ = _stacked(8)
    rst = rgp.fit_multitask(x, y, t, steps=5)
    st = _carry(rst)
    for a, b in zip(st[1:], rst[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    d = rgp.mt_params_to_dict(rst.params)
    assert gp.mt_params_to_dict(st.params) == d
    back = gp.mt_params_from_dict(json.loads(json.dumps(d)), device="cpu")
    assert gp.mt_params_to_dict(back) == d
    assert gp.params_to_dict(gp.shared_params(back)) == \
        rgp.params_to_dict(rgp.shared_params(rst.params))


# ---------------------------------------------------------------------------
# the reference's multi-task cases, through the port
# ---------------------------------------------------------------------------

def _f(c, shift=0.0):
    return (c["x"] - 0.3) ** 2 + (c["y"] - 0.7) ** 2 + 0.05 + shift


def _grid(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.95, size=(n, 2))


class TestMultiTaskGP:
    def _data(self, n=14, seed=0):
        x = _grid(n, seed).astype(np.float64)
        y0 = np.array([_f({"x": a, "y": b}) for a, b in x])
        y1 = y0 + 0.5                       # same landscape, shifted level
        xx = np.vstack([x, x])
        yy = np.concatenate([y0, y1])
        tt = np.concatenate([np.zeros(n, np.int32),
                             np.ones(n, np.int32)])
        return xx, yy, tt

    def test_fit_predict_tracks_each_task(self):
        x, y, t = self._data()
        st = gp.fit_multitask(x, y, t, steps=80, device="cpu")
        xq = _grid(6, seed=3).astype(np.float32)
        mu0, sd0 = gp.predict_multitask(st, xq, task=0)
        mu1, sd1 = gp.predict_multitask(st, xq, task=1)
        truth = np.array([_f({"x": a, "y": b}) for a, b in xq])
        assert np.all(np.asarray(sd0) > 0)
        # the learned per-task offsets carry the level difference
        assert np.mean(np.asarray(mu1) - np.asarray(mu0)) > 0.25
        assert np.mean(np.abs(np.asarray(mu0) - truth)) < 0.2

    def test_stacked_prior_for_unseen_task(self):
        x, y, t = self._data()
        st = gp.fit_multitask(x, y, t, steps=80, device="cpu")
        xq = _grid(5, seed=4).astype(np.float32)
        mu, sd = gp.predict_multitask(st, xq, task=None)
        mu0, _ = gp.predict_multitask(st, xq, task=0)
        mu1, _ = gp.predict_multitask(st, xq, task=1)
        assert np.all(np.isfinite(np.asarray(mu)))
        assert np.all(np.asarray(sd) > 0)
        lo = np.minimum(np.asarray(mu0), np.asarray(mu1)) - 0.2
        hi = np.maximum(np.asarray(mu0), np.asarray(mu1)) + 0.2
        assert np.all((np.asarray(mu) >= lo) & (np.asarray(mu) <= hi))

    def test_fit_routes_on_task_column(self):
        x, y, t = self._data()
        st = gp.fit(x, y, tasks=t, steps=20, pad=False, device="cpu")
        assert isinstance(st, gp.MTGPState)

    def test_single_task_fallback_is_exact(self):
        x = _grid(10).astype(np.float64)
        y = np.array([_f({"x": a, "y": b}) for a, b in x])
        plain = gp.fit(x, y, steps=25, pad=False, device="cpu")
        tasked = gp.fit(x, y, tasks=np.zeros(len(y), np.int32),
                        steps=25, pad=False, device="cpu")
        assert isinstance(tasked, gp.GPState)
        assert np.allclose(np.asarray(plain.alpha),
                           np.asarray(tasked.alpha))

    def test_multitask_warm_start_needs_mt_params(self):
        x, y, t = self._data()
        with pytest.raises(TypeError, match="MTGPParams"):
            gp.fit(x, y, tasks=t, steps=5, device="cpu",
                   params=gp.init_params(2, device="cpu"))

    def test_tasks_row_mismatch(self):
        x, y, t = self._data()
        with pytest.raises(ValueError, match="rows"):
            gp.fit(x, y, tasks=t[:-1], steps=5, device="cpu")

    def test_params_dict_roundtrip(self):
        p = gp.init_mt_params(3, 2, offsets=np.array([0.1, -0.2]),
                              device="cpu")
        d = gp.mt_params_to_dict(p)
        json.dumps(d)                        # wire-serializable
        q = gp.mt_params_from_dict(d, device="cpu")
        for a, b in zip(p, q):
            assert np.allclose(np.asarray(a), np.asarray(b))

    def test_shared_params_projection(self):
        x, y, t = self._data()
        st = gp.fit_multitask(x, y, t, steps=20, device="cpu")
        sp = gp.shared_params(st.params)
        assert isinstance(sp, gp.GPParams)
        assert np.allclose(np.asarray(sp.log_lengthscale),
                           np.asarray(st.params.log_lengthscale))

    def test_heteroscedastic_rows_downweighted(self):
        x, y, t = self._data(n=10)
        var = np.zeros(len(y))
        y_noisy = y.copy()
        y_noisy[3] += 5.0                    # wild outlier...
        var[3] = 25.0                        # ...flagged as such
        st = gp.fit_multitask(x, y_noisy, t, steps=40, obs_var=var,
                              device="cpu")
        st_trust = gp.fit_multitask(x, y_noisy, t, steps=40,
                                    device="cpu")
        xq = x[3][None].astype(np.float32)
        mu_down, _ = gp.predict_multitask(st, xq, task=0)
        mu_trust, _ = gp.predict_multitask(st_trust, xq, task=0)
        # the flagged fit pulls the outlier's posterior toward the rest
        assert abs(float(mu_down[0]) - y_noisy[3]) > \
            abs(float(mu_trust[0]) - y_noisy[3]) - 1e-6
