"""The GP fit's Adam step, factored out of the fit loop (``gp._adam_step``).

On the card the step is captured in a CUDA graph and replayed
(``test_torch_gp_cuda.py`` holds the replays bit-equal to the same step
run eagerly).  On the host the fit is a Python loop of the same step, and
it must reproduce, bit for bit, the loop it replaced: the Adam loop with
the bias corrections computed on the host every step, copied here as
``_host_loop_fit``.  The pinned CPU parity tests (``test_torch_gp.py``,
``test_torch_tuner.py``) rest on that.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import gp


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_loop_fit(params, x, y, kind, steps=200, lr=0.05, extra_noise=None,
                   use_kernel=False):
    """The fit loop before the step was factored out: host-side float
    bias corrections, new tensors every step."""
    p = [t.detach().clone() for t in params]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    t = np.float32(0.0)
    for _ in range(steps):
        leaves = [pi.requires_grad_(True) for pi in p]
        loss = gp.neg_log_marginal(gp.GPParams(*leaves), x, y, kind,
                                   extra_noise, use_kernel)
        grads = torch.autograd.grad(loss, leaves)
        t = t + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.float32(0.9) ** t)
        bc2 = float(np.float32(1.0) - np.float32(0.999) ** t)
        with torch.no_grad():
            for i, (lo, hi) in enumerate(gp._BOXES):
                g = torch.nan_to_num(grads[i])
                m[i] = 0.9 * m[i] + 0.1 * g
                v[i] = 0.999 * v[i] + 0.001 * g * g
                step = lr * (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + 1e-8)
                p[i] = torch.clamp(leaves[i] - step, lo, hi)
    return gp.GPParams(*p)


def _problem(n=26, d=3, seed=0, obs_var=False, pad_to=32):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d))
    y = np.sin(3 * x[:, 0]) + (x[:, 1] - 0.4) ** 2 + 0.1 * rng.normal(size=n)
    var = rng.uniform(0, 0.01, n) if obs_var else None
    xj, yj, ej, _, _ = gp._prepare(x, y, True, torch.device("cpu"), pad_to,
                                   var)
    return gp.init_params(d, device="cpu"), xj, yj, ej


@pytest.mark.parametrize("kind,use_kernel,obs_var", [
    ("matern52", False, False), ("matern52", True, False),
    ("matern52", True, True), ("rbf", False, False), ("rbf", False, True)])
def test_fit_reproduces_the_host_loop_bit_for_bit(kind, use_kernel, obs_var):
    params, x, y, extra = _problem(seed=3, obs_var=obs_var)
    got = gp._fit(params, x, y, kind, steps=40, extra_noise=extra,
                  use_kernel=use_kernel)
    want = _host_loop_fit(params, x, y, kind, steps=40, extra_noise=extra,
                          use_kernel=use_kernel)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fit_is_its_steps_one_by_one():
    """``gp.fit`` equals :func:`gp._adam_step` called by hand from the
    same init with the same buffers, bit for bit, and the step leaves the
    step index advanced."""
    params, x, y, extra = _problem(seed=5, obs_var=True)
    steps = 25
    p = gp._flat(params)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    t = torch.zeros((1,), dtype=torch.int64)
    table = torch.tensor(gp._bias_table(steps))
    bounds = gp._box_bounds(x.shape[1], "cpu")
    for _ in range(steps):
        gp._adam_step(p, m, v, t, table, bounds, x, y, "matern52", 0.05,
                      extra, use_kernel=True)
    assert int(t) == steps
    got = gp._fit(params, x, y, "matern52", steps=steps, extra_noise=extra,
                  use_kernel=True)
    for a, b in zip(got, gp._unflat(p)):
        assert torch.equal(a, b)


def test_bias_table_is_the_host_loops_float32_arithmetic():
    table = gp._bias_table(150)
    assert table.dtype == np.float32 and table.shape == (150, 2)
    t = np.float32(0.0)
    for row in table:
        t = t + np.float32(1.0)
        assert row[0] == np.float32(1.0) - np.float32(0.9) ** t
        assert row[1] == np.float32(1.0) - np.float32(0.999) ** t


def test_warm_start_fit_matches_the_host_loop():
    """A warm-started fit (fewer steps from fitted params, as
    ``BOStrategy`` runs it) reads the first rows of its own table."""
    params, x, y, extra = _problem(seed=9)
    cold = gp._fit(params, x, y, "matern52", steps=30, use_kernel=True)
    got = gp._fit(cold, x, y, "matern52", steps=10, use_kernel=True)
    want = _host_loop_fit(cold, x, y, "matern52", steps=10, use_kernel=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
