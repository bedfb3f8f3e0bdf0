"""``Sapphire.tune()`` end to end: the port against the JAX reference.

Small budgets (40 ranking samples, 6 + 12 BO evaluations over 128
candidates, 30 Adam steps).  Ranking, design and every probe's noise are
host work and match exactly (values to rtol 1e-6, the evaluator noise
contract).  The GP is refitted every round by each package's own Adam
loop, whose float drift (see ``test_torch_gp``) can tip a later argmax:
at ``batch_size=1`` the traces agree through the 10th BO pick and depart
at the 11th; at ``batch_size=4`` they agree through all 18 evaluations.
The test holds the top-K list, the initial design and the first round of
picks to the reference exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.strategy import BOConfig as RefBOConfig
from repro.core.tuner import Sapphire as RefSapphire
from repro_torch.core.controller import Controller, EvalDB
from repro_torch.core.evaluators import AnalyticEvaluator
from repro_torch.core.strategy import BOConfig, BOStrategy
from repro_torch.core.tuner import Sapphire
from repro_torch.configs import get_config
from repro_torch.core import gp, knobs
from repro_torch.core.costmodel import SINGLE_POD
from repro_torch.models.config import SHAPES_BY_NAME

SMALL = dict(n_init=6, n_iter=12, n_candidates=128, fit_steps=30)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tune(batch_size, **kw):
    common = dict(arch="yi-6b", shape="train_4k", n_rank_samples=40,
                  batch_size=batch_size)
    port = Sapphire(bo_config=BOConfig(**SMALL), device="cpu", **common,
                    **kw).tune()
    ref = RefSapphire(bo_config=RefBOConfig(**SMALL), **common).tune()
    return port, ref


@pytest.mark.parametrize("batch_size", [1, 4])
def test_tune_matches_reference(batch_size):
    port, ref = _tune(batch_size)
    assert port.ranking.top(16) == ref.ranking.top(16)
    np.testing.assert_allclose(port.ranking.values, ref.ranking.values,
                               rtol=1e-6)
    n0 = SMALL["n_init"] + batch_size          # design + first BO round
    assert port.trace.configs[:n0] == ref.trace.configs[:n0]
    np.testing.assert_allclose(port.trace.values[:n0], ref.trace.values[:n0],
                               rtol=1e-6)
    assert port.n_evaluations == ref.n_evaluations == 40 + 6 + 12
    assert port.default_value == pytest.approx(ref.default_value, rel=1e-6)
    assert port.expert_value == pytest.approx(ref.expert_value, rel=1e-6)
    assert port.clean_report == ref.clean_report
    assert port.best_value <= port.default_value
    sub = {k: v for k, v in port.best_config.items()
           if k in port.final_space.names}
    assert port.final_space.validate(sub) == []


def test_tune_async_eval_is_trace_identical():
    common = dict(arch="yi-6b", shape="train_4k", n_rank_samples=40,
                  batch_size=4, bo_config=BOConfig(**SMALL), device="cpu")
    sync = Sapphire(**common).tune()
    asyn = Sapphire(async_eval=True, **common).tune()
    assert asyn.ranking.top(16) == sync.ranking.top(16)
    assert asyn.trace.configs == sync.trace.configs
    assert asyn.trace.values == sync.trace.values
    assert asyn.best_config == sync.best_config


def _bo_space():
    space, _, _ = knobs.clean_space(get_config("yi-6b"),
                                    SHAPES_BY_NAME["train_4k"], SINGLE_POD)
    names = ["tensor_parallel", "microbatch", "remat_policy",
             "matmul_precision", "fsdp_shard_params"]
    return space, space.subset(names)


def test_controller_run_and_run_async_match():
    space, sub = _bo_space()
    complete = space.overlaid(sub).completer()

    def mk():
        return BOStrategy(sub, BOConfig(n_init=4, n_iter=8, batch_size=4,
                                        n_candidates=32, fit_steps=10,
                                        device="cpu", seed=7))

    def ctrl():
        ev = AnalyticEvaluator(get_config("yi-6b"),
                               SHAPES_BY_NAME["train_4k"], SINGLE_POD)
        return Controller(ev, EvalDB()).with_prepare(complete)

    t_sync = ctrl().run(mk())
    t_async = ctrl().run_async(mk())
    assert t_sync.configs == t_async.configs
    assert t_sync.values == t_async.values


def test_default_device_is_the_card():
    """No silent CPU fallback: without CUDA the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Sapphire(n_rank_samples=10).tune()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gp.fit(np.random.default_rng(0).random((4, 2)), np.arange(4.0))


def test_module_entry_point_runs_on_the_host():
    """``python -m repro_torch --device cpu --quick`` (the example's
    flags) runs the whole pipeline and reports the recommendation."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "--device", "cpu", "--quick",
         "--batch", "8"], capture_output=True, text=True, env=env,
        timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr
    assert "speedup vs default" in out.stdout
    assert "top knobs" in out.stdout
