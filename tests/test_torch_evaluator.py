"""The port's analytic test cluster against the JAX reference.

The noise is rebuilt in numpy (threefry2x32 + jax's bits→normal
transform): its uint32 bits must equal ``jax.random.bits`` exactly, and
every probe must match the reference within rtol 1e-6 — the remaining gap
is float64 ``erfinv`` against XLA's float32 polynomial (~2e-5 in z, so
~5e-7 relative in exp(0.025·z)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core.evaluators import AnalyticEvaluator as RefEvaluator
from repro.core.evaluators import evaluate_many as ref_evaluate_many
from repro.core.knobs import clean_space as ref_clean_space
from repro.core.sampling import latin_hypercube
from repro.core.costmodel import SINGLE_POD as REF_SINGLE_POD
from repro.models.config import SHAPES_BY_NAME as REF_SHAPES
from repro_torch.configs import get_config
from repro_torch.core import evaluators as pe
from repro_torch.core.costmodel import SINGLE_POD
from repro_torch.models.config import SHAPES_BY_NAME

RTOL = 1e-6


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    keys[:4] = [[0, 0], [0, 1], [1, 0], [0xFFFFFFFF, 0xFFFFFFFF]]
    return keys


def test_threefry_bits_equal_jax():
    keys = _keys(512, seed=1)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(
        jnp.asarray(keys)))
    np.testing.assert_array_equal(pe.threefry_bits(keys), want)


def test_std_normal_matches_jax():
    keys = _keys(512, seed=2)
    want = np.asarray(jax.vmap(jax.random.normal)(jnp.asarray(keys)))
    got = pe.std_normal(keys)
    assert got.dtype == np.float32
    # float64 erfinv rounded vs XLA's float32 polynomial
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def _pair(seed=0, sigma=0.025):
    cfg, cell = get_config("yi-6b"), SHAPES_BY_NAME["train_4k"]
    rcfg, rcell = ref_get_config("yi-6b"), REF_SHAPES["train_4k"]
    space, _, _ = ref_clean_space(rcfg, rcell, REF_SINGLE_POD)
    configs = latin_hypercube(space, 24, seed=seed)
    ref = RefEvaluator(rcfg, rcell, REF_SINGLE_POD, noise_sigma=sigma,
                       seed=seed)
    port = pe.AnalyticEvaluator(cfg, cell, SINGLE_POD, noise_sigma=sigma,
                                seed=seed)
    return configs, ref, port


@pytest.mark.parametrize("seed", [0, 7])
def test_call_matches_reference(seed):
    configs, ref, port = _pair(seed)
    for i, c in enumerate(configs):
        s = None if i % 3 else 1000 + i          # seeded and unseeded rows
        np.testing.assert_allclose(port(c, seed=s), ref(c, seed=s),
                                   rtol=RTOL)
    assert port.calls == ref.calls
    assert [h["true_step_s"] for h in port.history] == \
        [h["true_step_s"] for h in ref.history]


@pytest.mark.parametrize("seeded", [False, True])
def test_batch_matches_reference_and_sequential(seeded):
    configs, ref, port = _pair(3)
    seeds = [50 + i if seeded and i % 2 else None
             for i in range(len(configs))]
    got, bds = port.evaluate_batch_detailed(configs, seeds)
    want, rbds = ref.evaluate_batch_detailed(configs, seeds)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert [b.feasible for b in bds] == [b.feasible for b in rbds]
    # a batch reproduces the stream of sequential calls
    _, _, seq = _pair(3)
    one = [seq(c, seed=s) for c, s in zip(configs, seeds)]
    np.testing.assert_allclose(got, one, rtol=RTOL)


def test_noise_free_and_evaluate_many():
    configs, ref, port = _pair(0, sigma=0.0)
    np.testing.assert_array_equal(
        pe.evaluate_many(port, configs[:6]),
        ref_evaluate_many(ref, configs[:6]))
