"""Sapphire: the end-to-end configuration recommender (paper Fig. 3).

    result = Sapphire(arch="yi-6b", shape="train_4k").tune()

``tune()`` is three composable stages, each driving a registry strategy
through the experiment-loop Controller:

  1. **rank**   (§3.3) — an LHS design strategy scored on the test-cluster
     evaluator, Lasso-path importance, keep top-K knobs (others pinned);
  2. **search** (§3.4) — any registered strategy (GP-BO with dynamic
     boundaries by default; ``strategy="sa"|"ga"|"random"`` for the
     baselines) over the top-K sub-space, probes expanded to full configs
     by the Controller's ``prepare`` hook;
  3. **validate** — probe the default and "expert manual" baseline configs
     and assemble the report (recommended config, improvement, trace).

The stages are ordinary methods taking a Controller, so callers can rerun
any one of them against a different evaluator or database — e.g. re-rank
an existing EvalDB.

``device`` is where the lasso path and the GP run: the card by default;
``device="cpu"`` runs everything on the host.  Without CUDA the default
raises instead of falling back.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Tuple

from repro_torch.configs import get_config
from repro_torch.core import knobs as knobmod, ranking
from repro_torch.core.controller import Controller, EvalDB
from repro_torch.core.costmodel import MULTI_POD, SINGLE_POD, MeshShape
from repro_torch.core.evaluators import AnalyticEvaluator
from repro_torch.core.space import Config, Space
from repro_torch.core.strategy import BOConfig, Trace, make_strategy
from repro_torch.device import resolve_device
from repro_torch.models.config import SHAPES_BY_NAME


def expert_manual_config(space: Space) -> Config:
    """The 'expert manual tuning' baseline (paper §4.4's Micron guide
    analogue): a sensible hand rule — flash attention with big aligned
    blocks, full remat, biggest microbatch, bf16 grads — applied blindly,
    i.e. without knowing the workload (which is the paper's point about
    why it sometimes loses)."""
    cfg = space.default_config()
    hand = {
        "attention_impl": "flash", "flash_block_q": 1024, "flash_block_k": 1024,
        "remat_policy": "full", "grad_allreduce_dtype": "bfloat16",
        "fsdp_shard_params": True, "tensor_parallel": True,
        "pod_hierarchical_allreduce": True,
    }
    mb = space.knob("microbatch") if "microbatch" in space.names else None
    if mb is not None:
        hand["microbatch"] = int(mb.hi)
    for k, v in hand.items():
        if k in space.names:
            cfg[k] = v
    return space.project(cfg)


@dataclass
class TuneResult:
    arch: str
    shape: str
    mesh: MeshShape
    clean_report: Dict[str, int]
    ranking: ranking.RankingResult
    top_k: int
    best_config: Config            # full config (pins + defaults + tuned)
    best_value: float
    default_value: float
    expert_value: float
    trace: Trace
    final_space: Space             # after dynamic-boundary enlargements
    n_evaluations: int             # tuning evaluations only (rank + search;
                                   # the default/expert baseline probes are
                                   # report overhead, not search budget)

    @property
    def speedup_vs_default(self) -> float:
        return self.default_value / max(self.best_value, 1e-12)

    @property
    def speedup_vs_expert(self) -> float:
        return self.expert_value / max(self.best_value, 1e-12)

    def summary(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape,
            "clean_domain": self.clean_report,
            "top_k": self.top_k,
            "top_knobs": self.ranking.top(self.top_k),
            "best_step_s": self.best_value,
            "default_step_s": self.default_value,
            "expert_step_s": self.expert_value,
            "speedup_vs_default": round(self.speedup_vs_default, 3),
            "speedup_vs_expert": round(self.speedup_vs_expert, 3),
            "n_evaluations": self.n_evaluations,
            "boundary_events": self.trace.boundary_events,
        }


@dataclass
class Sapphire:
    arch: str = "yi-6b"
    shape: str = "train_4k"
    multi_pod: bool = False
    top_k: int = 16
    n_rank_samples: int = 300
    batch_size: int = 1            # q-batch width: probes per GP refit AND
                                   # configs per Experiment-Unit round;
                                   # 1 = the paper's sequential loop
    rank_batch_size: Optional[int] = None  # ranking chunk (None: 64 when
                                           # batching, else sequential)
    strategy: str = "bo"           # search-stage strategy (registry name)
    bo_config: Optional[BOConfig] = None
    pinned: Optional[Dict[str, object]] = None
    noise_sigma: float = 0.025
    seed: int = 0
    db_path: Optional[str] = None
    async_eval: bool = False       # drive rank/search through the
                                   # overlapped Controller.run_async loop
                                   # (same search on the immediate
                                   # analytic service — values equal to
                                   # float ULP; a wall-clock win when the
                                   # service streams out of order)
    async_max_in_flight: Optional[int] = None  # concurrent probes in the
                                   # async loop (None: each stage's batch
                                   # width — sync pacing with streamed
                                   # tells; raise toward workers+min_ask
                                   # on a slow streaming service)
    async_min_ask: int = 1         # coalesce completion waves before the
                                   # next ask (amortizes GP refits)
    evaluator: Optional[Callable[[Config], float]] = None  # override (tests)
    device: str = "cuda"           # lasso path + GP (cpu: host only)

    def _setup(self):
        resolve_device(self.device)        # fail fast: no silent fallback
        model_cfg = get_config(self.arch)
        cell = SHAPES_BY_NAME[self.shape]
        mesh = MULTI_POD if self.multi_pod else SINGLE_POD
        space, pins, report = knobmod.clean_space(model_cfg, cell, mesh,
                                                  self.pinned)
        ev = self.evaluator or AnalyticEvaluator(
            model_cfg, cell, mesh, noise_sigma=self.noise_sigma,
            seed=self.seed)
        # every request/record carries the cell it was measured on, so a
        # shared evaluation DB can be sliced per workload
        ctrl = Controller(ev, EvalDB(self.db_path),
                          workload=f"{self.arch}:{self.shape}")
        return model_cfg, cell, mesh, space, pins, report, ctrl

    # ---- stage 1: §3.3 ranking over the clean domain ------------------------

    def rank_stage(self, ctrl: Controller, space: Space,
                   strategy: str = "random") -> ranking.RankingResult:
        rank_bs = self.rank_batch_size
        if rank_bs is None:
            rank_bs = 64 if self.batch_size > 1 else 1
        return ranking.rank_with_controller(
            space, ctrl.with_tag("rank"), n_samples=self.n_rank_samples,
            seed=self.seed, batch_size=rank_bs, strategy=strategy,
            async_eval=self.async_eval,
            max_in_flight=self.async_max_in_flight or rank_bs,
            min_ask=self.async_min_ask, device=self.device)

    # ---- stage 2: §3.4 search over the top-K sub-space -----------------------

    def search_stage(self, ctrl: Controller, space: Space,
                     rk: ranking.RankingResult, strategy: Optional[str] = None
                     ) -> Tuple[Config, float, Trace, Space]:
        """Drive the named registry strategy over the top-K sub-space.
        Returns (best full config, best value, trace, final sub-space)."""
        strategy = strategy or self.strategy
        sub = rk.top_space(self.top_k)

        bo_cfg = replace(self.bo_config or BOConfig(seed=self.seed),
                         device=self.device)
        if self.batch_size != 1:
            # batching opts into the full batched redesign: q-EI probes
            # AND warm-started GP hyperparameters across rounds
            bo_cfg = replace(bo_cfg, batch_size=self.batch_size,
                             warm_start=True)
        if strategy == "bo":
            strat = make_strategy("bo", sub, cfg=bo_cfg)
        else:
            # non-BO strategies get the same evaluation budget and the
            # same configs-per-round as the BO loop would
            strat = make_strategy(strategy, sub, seed=self.seed,
                                  budget=bo_cfg.n_init + bo_cfg.n_iter,
                                  batch_size=self.batch_size)

        # non-top knobs are pinned at their defaults inside the evaluator.
        # The completer follows the strategy's live space: when a dynamic
        # boundary is enlarged (paper Fig. 4), the enlarged probes must
        # reach the evaluator unclipped.
        _cache: Dict[str, object] = {}

        def _full(sub_cfg: Config) -> Config:
            if _cache.get("sub") is not strat.space:
                _cache["sub"] = strat.space
                _cache["complete"] = space.overlaid(strat.space).completer()
            return _cache["complete"](sub_cfg)

        search_ctrl = ctrl.with_tag(strategy).with_prepare(_full)
        bs = None if strategy == "bo" else self.batch_size
        if self.async_eval:
            # default depth = the search's actual round width — the BO
            # strategy's own q when a bo_config overrides it, so a
            # q-batch search is not squeezed into 1-probe asks: sync
            # pacing with streamed tells; raise async_max_in_flight to
            # keep a slow streaming service saturated through refits
            width = max(self.batch_size,
                        bo_cfg.batch_size if strategy == "bo" else 1)
            trace = search_ctrl.run_async(
                strat, batch_size=bs,
                max_in_flight=self.async_max_in_flight or width,
                min_ask=self.async_min_ask)
        else:
            trace = search_ctrl.run(strat, batch_size=bs)
        best_sub, best_v = strat.best()
        close = getattr(strat, "close", None)
        if close is not None:
            close()        # join a refit_async background executor, if any
        return _full(best_sub), best_v, trace, strat.space

    # ---- stage 3: baseline probes + report -----------------------------------

    def validate_stage(self, ctrl: Controller,
                       space: Space) -> Tuple[float, float]:
        """Probe the default and expert-manual baselines (tagged, so they
        never count toward the reported tuning budget)."""
        defaults = space.project(space.default_config())
        expert = expert_manual_config(space)
        dv = ctrl.with_tag("default")(defaults)
        ev_ = ctrl.with_tag("expert")(expert)
        return dv, ev_

    # ---- the pipeline --------------------------------------------------------

    def tune(self) -> TuneResult:
        model_cfg, cell, mesh, space, pins, report, ctrl = self._setup()
        n_preexisting = len(ctrl.db)           # warm-started DBs reload here

        rk = self.rank_stage(ctrl, space)
        best_full, best_v, trace, final_sub = self.search_stage(
            ctrl, space, rk)
        best_full = dict(best_full)
        best_full.update(pins)
        n_evals = len(ctrl.db) - n_preexisting  # rank + search only
        dv, ev_ = self.validate_stage(ctrl, space)

        return TuneResult(
            arch=self.arch, shape=self.shape, mesh=mesh,
            clean_report=report, ranking=rk, top_k=self.top_k,
            best_config=best_full, best_value=best_v,
            default_value=dv, expert_value=ev_,
            trace=trace, final_space=final_sub,
            n_evaluations=n_evals,
        )
