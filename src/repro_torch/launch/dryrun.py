"""Product-cluster run of one (arch × shape) cell: build its step on the
card, run it, time it (from ``repro.launch.dryrun``).

The reference lowers and compiles every cell on a forced 512-device CPU
mesh and reads three roofline terms out of the compiled HLO.  The port
has one real card instead, so it runs the configured step there, as
Sapphire's product cluster (the paper's Ceph deployment) runs a
recommended config:

  1. the full (paper-exact) ModelConfig, cut in depth where the card
     asks for it (:func:`cell_depth`: one depth for every config of a
     cell), and the per-arch default RunConfig
     (:func:`default_runconfig`, the reference's, with each config's
     ``RUN_OVERRIDES`` and the caller's knobs);
  2. one data-parallel replica's share of the cell on the card:
     ``global_batch // data_parallel_size(shard, production mesh)``
     sequences (``train_4k``: 16 x 4096 tokens on the 16 x 16 mesh).  The
     16-way tensor-parallel split is not simulated: the card does the
     replica's whole model work;
  3. the step for the cell's mode with weights, state and inputs made on
     the device from a seed (:func:`lower_cell`): ``make_train_step``
     (donated state), ``Model.prefill``, or one ``Model.decode_step``
     against an S-long cache;
  4. one warm-up step, counted (``roofline.count_step``: FLOPs, an HBM
     bytes proxy, the kernels' own work) and timed with the build as
     ``compile_s``; then ``steps`` timed steps, each ending in a
     synchronise, whose median is ``measured_step_s``;
  5. the record (:func:`compile_cell`): the reference's keys, the
     roofline terms against ``roofline.H100``, and what was measured.
     :func:`run_cell` writes it to
     ``artifacts/dryrun/<arch>.<shape>.1xH100.json`` (the reference's
     records are ``...16x16.json`` and are never overwritten).

This module sets no ``XLA_FLAGS`` and imports no JAX.

CLI:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
        [--device cpu] [--layers 2] [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--skip-existing]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import importlib
import json
import statistics
import subprocess
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs import ARCH_IDS, canonical, get_config
from repro_torch.core.costmodel import REMAT_ACT_FRACTION, _bytes_of
from repro_torch.device import resolve_device
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import tree_flatten
from repro_torch.models.config import (SHAPES_BY_NAME, ModelConfig,
                                       ShapeCell, applicable_shapes)
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import data_parallel_size
from repro_torch.runconfig import RunConfig, runconfig_from_knobs
from repro_torch.train.train_loop import init_state, make_train_step

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"
# the share of the card estimate_bytes may take when fit_depth picks the
# depth; the rest is slack for what the estimate leaves out
FIT_FRACTION = 0.9
SEED = 0                 # of the weights, the optimizer state and the tokens


def default_runconfig(cfg: ModelConfig, cell: ShapeCell,
                      knobs: Optional[Dict] = None) -> RunConfig:
    """Per-arch default RunConfig (+ optional SAPPHIRE knob overrides)."""
    # the framework's shipped family defaults: memory-safe but untuned
    # (the SAPPHIRE baseline; the paper's "default configuration")
    over: Dict = {}
    if cell.mode == "train":
        over.update(remat_policy="block", microbatch=4)
    if cell.mode == "decode":
        # serving keeps weights data-replicated: ZeRO-3 storage would
        # re-gather every weight on every token (measured 9.3 GB/step)
        over.update(fsdp_shard_params=False)
    if cfg.has_attention:
        # chunked online-softmax everywhere: never materializes [S, S]
        over.update(attention_impl="chunked", chunk_size_k=2048)
    try:
        mod = importlib.import_module(
            f"repro_torch.configs.{canonical(cfg.name)}")
        over.update(getattr(mod, "RUN_OVERRIDES", {}))
    except ModuleNotFoundError:
        pass
    if cell.name == "long_500k":
        over.setdefault("shard_kv_seq", True)
    if knobs:
        over.update(knobs)
    rc = runconfig_from_knobs(over)
    # non-shard fields live on the flat RunConfig
    fields = {k: v for k, v in over.items() if hasattr(rc, k)}
    return rc.replace(**fields)


def _state_bytes_per_param(rc: RunConfig, train: bool) -> int:
    """Bytes a parameter holds on the card: the weight, and in training
    its float32 master, AdamW's two float32 moments (Adafactor's are
    factored: a row and a column per matrix, not counted) and its
    gradient (a float32 accumulator and one microbatch's bf16 gradient)."""
    n = 4 if rc.param_dtype == "float32" else 2
    if train:
        n += 4 if rc.master_weights_f32 else 0
        n += 8 if rc.optimizer == "adamw" else 0
        n += 6
    return n


def estimate_bytes(cfg: ModelConfig, rc: RunConfig, mode: str,
                   batch: int, seq: int) -> float:
    """An estimate of the step's peak bytes on the card, for choosing the
    depth: the state (:func:`_state_bytes_per_param`); in training the
    cost model's live activations of a microbatch under ``rc``'s remat
    policy and its float32 logits with their gradient; in serving the KV
    cache and the logits; and one layer's attention temporaries: unless
    attention is flash, its float32 scores (training keeps every chunk's
    for the layer's backward, scores, probabilities and their gradient;
    prefill four copies of one chunk's: the scores, the masked scores,
    their difference from the row maxima and its exponential), and in
    decode the cache's keys and values widened to the query heads in
    bf16 and float32."""
    train = mode == "train"
    n = cfg.param_count() * _state_bytes_per_param(rc, train)
    micro = min(rc.microbatch or batch, batch) if train else batch
    if train:
        layer_io = 12 if cfg.has_attention else 8
        n += (micro * seq * cfg.d_model * _bytes_of(rc.activation_dtype)
              * layer_io * REMAT_ACT_FRACTION[rc.remat_policy] * cfg.n_layers)
        n += micro * seq * cfg.vocab_size * 4 * 2
    else:
        n += (2 * batch * seq * cfg.kv_dim * _bytes_of(rc.kv_cache_dtype)
              * cfg.attn_layer_count)
        n += batch * (1 if mode == "decode" else seq) * cfg.vocab_size * 4
    if not cfg.has_attention:
        return n
    if mode == "decode":
        n += batch * seq * cfg.q_dim * 12
    elif rc.attention_impl != "flash":
        keys = seq if train or rc.attention_impl == "reference" \
            else min(seq, rc.chunk_size_k)
        n += (3 if train else 4) * micro * cfg.n_heads * seq * keys * 4
    return n


def fit_depth(cfg: ModelConfig, rc: RunConfig, hbm_bytes: float, *,
              mode: str = "train", batch: int = 1, seq: int = 1) -> int:
    """The deepest whole number of layer periods (at least one, at most
    the config's) whose :func:`estimate_bytes` under ``rc`` fits in
    ``FIT_FRACTION`` of ``hbm_bytes``; returned as a layer count."""
    period = len(cfg.pattern)
    for groups in range(cfg.n_groups, 1, -1):
        cut = cfg.scaled(n_layers=groups * period)
        if estimate_bytes(cut, rc, mode, batch, seq) \
                <= FIT_FRACTION * hbm_bytes:
            return groups * period
    return period


def replica_shape(cell: ShapeCell, rc: RunConfig, mesh: Dict[str, int],
                  reduce: Optional[Dict[str, int]] = None):
    """(batch, seq, cuts): one data-parallel replica's share of the cell,
    and ``reduce``'s cuts of it."""
    B = max(cell.global_batch // data_parallel_size(rc.shard, mesh), 1)
    S = cell.seq_len
    reduce = reduce or {}
    cuts = []
    if "batch" in reduce and reduce["batch"] != B:
        cuts.append(f"batch {B} -> {reduce['batch']}")
        B = reduce["batch"]
    if "seq" in reduce and reduce["seq"] != S:
        cuts.append(f"seq_len {S} -> {reduce['seq']}")
        S = reduce["seq"]
    return B, S, cuts


def cell_depth(cfg: ModelConfig, cell: ShapeCell, *,
               multi_pod: bool = False,
               reduce: Optional[Dict[str, int]] = None,
               hbm_bytes: float = rl.H100.hbm_bytes) -> int:
    """The depth one cell is measured at when none is given: what
    :func:`fit_depth` picks for the family default (``default_runconfig``
    with no knobs) at the replica's share.  It does not depend on the
    knobs, so every config of a cell runs the same model; a config whose
    step needs more than the family default's may run out of the card's
    memory at this depth (a failed evaluation)."""
    rc = default_runconfig(cfg, cell)
    B, S, _ = replica_shape(cell, rc, make_production_mesh(
        multi_pod=multi_pod), reduce)
    return fit_depth(cfg, rc, hbm_bytes, mode=cell.mode, batch=B, seq=S)


@dataclasses.dataclass
class Lowered:
    """One cell's step built on the device: ``step()`` runs one step and
    returns the loss (train) or the logits."""
    step: Callable[[], torch.Tensor]
    cfg: ModelConfig                 # at the cut
    batch: int
    seq_len: int
    tokens: int                      # per step
    state_bytes: int                 # weights + optimizer or decode state
    batch_bytes: int
    reduced: List[str]
    grad_norms: List[torch.Tensor] = dataclasses.field(default_factory=list)


def _nbytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def lower_cell(cfg: ModelConfig, cell: ShapeCell, rc: RunConfig,
               mesh: Dict[str, int], *, device, n_layers: int,
               reduce: Optional[Dict[str, int]] = None) -> Lowered:
    """Build one cell's step on ``device``: the model cut to ``n_layers``,
    weights (and optimizer state) from ``SEED``, and one replica's share
    of the cell's batch (``reduce`` may cut its ``"batch"`` and ``"seq"``)
    as seeded random tokens."""
    dev = resolve_device(device)
    reduced = []
    if n_layers != cfg.n_layers:
        reduced.append(f"n_layers {cfg.n_layers} -> {n_layers}")
        cfg = cfg.scaled(n_layers=n_layers)
    B, S, cuts = replica_shape(cell, rc, mesh, reduce)
    reduced += cuts
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    width = 1 if cell.mode == "decode" else S + 1
    toks = torch.randint(0, cfg.vocab_size, (B, width), generator=gen,
                         device=dev, dtype=torch.int32)
    inputs = {"tokens": toks[:, :S]}
    if cfg.is_encoder_decoder:
        inputs["frames"] = torch.randn(
            (B, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev,
            dtype=torch.bfloat16)

    if cell.mode == "train":
        inputs["labels"] = toks[:, 1:]
        step_fn = make_train_step(model, rc, donate=True)
        box = [init_state(model, SEED, rc)]
        state_bytes = _nbytes(box[0])
        norms: List[torch.Tensor] = []

        def step():
            box[0], metrics = step_fn(box[0], inputs)
            norms.append(metrics["grad_norm"])
            return metrics["loss"]
        return Lowered(step, cfg, B, S, B * S, state_bytes,
                       _nbytes(inputs), reduced, norms)

    params = model.init(SEED)
    if cell.mode == "prefill":
        @torch.no_grad()
        def step():
            return model.prefill(params, inputs, S, rc)[0]
        return Lowered(step, cfg, B, S, B * S, _nbytes(params),
                       _nbytes(inputs), reduced)

    # decode: one token against an S-long cache (S - 1 tokens already in)
    if cfg.is_encoder_decoder:
        state = model.init_decode_state(inputs, B, S, rc, params)
    else:
        state = model.init_decode_state(B, S, rc)
    state = state._replace(pos=torch.full_like(state.pos, S - 1))

    @torch.no_grad()
    def step():
        return model.decode_step(params, toks, state, rc)[0]
    return Lowered(step, cfg, B, S, B, _nbytes(params, state),
                   _nbytes(toks), reduced)


@functools.lru_cache(maxsize=None)
def card_name(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit unknown"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure(cfg, cell, rc, mesh, dev, n_layers, steps, reduce) -> Dict:
    """Build, warm up (counted), time; the record's measured part.  Every
    tensor of the cell lives in this frame and goes when it returns."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    low = lower_cell(cfg, cell, rc, mesh, device=dev, n_layers=n_layers,
                     reduce=reduce)
    counts, first = rl.count_step(low.step)
    _sync(dev)
    compile_s = time.monotonic() - t0
    finite = bool(torch.isfinite(first).all())
    train = cell.mode == "train"
    losses, times = [first], []         # train: each step's scalar loss
    for _ in range(steps):
        t = time.perf_counter()
        out = low.step()
        _sync(dev)
        times.append(time.perf_counter() - t)
        if train:
            losses.append(out)
    finite = finite and bool(torch.isfinite(out).all())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    return {"low": dataclasses.replace(low, step=None, grad_norms=[]),
            "counts": counts, "compile_s": compile_s, "times": times,
            "losses": [float(x) for x in losses] if train else None,
            "grad_norm": float(low.grad_norms[0]) if train else None,
            "outputs_finite": finite, "peak": peak}


def compile_cell(cfg: ModelConfig, cell: ShapeCell,
                 knobs: Optional[Dict] = None, *, multi_pod: bool = False,
                 device="cuda", n_layers: Optional[int] = None,
                 steps: int = 2, reduce: Optional[Dict[str, int]] = None,
                 verbose: bool = False) -> Dict:
    """Build, run and time one cell on ``device``; return the record.

    A step that runs out of the card's memory raises
    ``torch.cuda.OutOfMemoryError`` (its state is dropped, never reused);
    every tensor of the cell is freed and the allocator's cache emptied
    before this returns or raises."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rc = default_runconfig(cfg, cell, knobs)
    train = cell.mode == "train"
    if n_layers is None:
        n_layers = cell_depth(cfg, cell, multi_pod=multi_pod, reduce=reduce)
    failure = None
    try:
        m = _measure(cfg, cell, rc, mesh, dev, n_layers, steps, reduce)
    except Exception as e:            # noqa: BLE001 -- re-raised below
        # the traceback holds the step's frames (and their tensors): keep
        # its text, drop the frames so the memory goes before the error
        # travels on (an evaluation service keeps the exception)
        text = "".join(traceback.format_exception(e))
        failure = e.with_traceback(None)
        failure.add_note(f"raised in the step:\n{text}")
    finally:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if failure is not None:
        raise failure

    low, counts = m["low"], m["counts"]
    report = rl.report_from_counts(counts.flops, counts.hbm_bytes, 0.0,
                                   rl.H100)
    measured = statistics.median(m["times"])
    mflops = rl.model_flops(low.cfg.active_param_count(), low.tokens, train)
    cuda = dev.type == "cuda"
    record = {
        "arch": cfg.name, "shape": cell.name,
        "mesh": "1xH100" if cuda else "1xCPU", "chips": 1,
        "mode": cell.mode,
        "compile_s": m["compile_s"],
        "memory": {
            "state_size_gb": low.state_bytes / 2**30,
            "batch_size_gb": low.batch_bytes / 2**30,
            "max_memory_allocated_gb":
                m["peak"] / 2**30 if m["peak"] is not None else None,
            "estimated_gb": estimate_bytes(
                low.cfg, rc, cell.mode, low.batch, low.seq_len) / 2**30,
        },
        "roofline": {
            "flops_per_device": report.flops,
            "hbm_bytes_per_device": report.bytes_proxy,
            "collective_bytes_per_device": report.collective_bytes,
            "coll_by_kind": report.coll_by_kind,
            "compute_s": report.compute_s,
            "memory_s": report.memory_s,
            "collective_s": report.collective_s,
            "step_s": report.step_s,
            "dominant": report.dominant,
            "trip_counts": report.trip_counts,
            "kernel_flops": counts.kernel_flops,
            "kernel_bytes": counts.kernel_bytes,
            "hbm_bytes_by_device": counts.bytes_by_device,
        },
        "model_flops_6nd": mflops,
        "useful_flops_ratio": mflops / counts.flops if counts.flops else None,
        "raw_cost_analysis_flops": None,      # no XLA cost analysis
        "runconfig": {k: getattr(rc, k) for k in
                      ("microbatch", "remat_policy", "attention_impl",
                       "optimizer", "master_weights_f32",
                       "grad_allreduce_dtype")},
        "measured_step_s": measured,
        "step_times_s": m["times"],
        "tokens_per_s": low.tokens / measured,
        # a CPU time is no card's utilisation
        "mfu": mflops / (measured * rl.H100.peak_flops) if cuda else None,
        # every step's loss on the one batch, the warm-up's (step 1's,
        # before any update) first, and step 1's gradient norm
        "step1_loss": m["losses"][0] if train else None,
        "step_losses": m["losses"],
        "step1_grad_norm": m["grad_norm"],
        "outputs_finite": m["outputs_finite"],
        "batch": low.batch, "seq_len": low.seq_len, "tokens": low.tokens,
        "n_layers": low.cfg.n_layers,
        "reduced": low.reduced,
        "card": card_name(dev.index or 0) if cuda else "cpu",
    }
    if verbose:
        print(json.dumps(record, indent=1, default=str))
    return record


def _artifact(arch: str, shape: str, mesh_tag: str, multi_pod: bool):
    pod = ".multi-pod" if multi_pod else ""
    return ARTIFACTS / f"{canonical(arch)}.{shape}{pod}.{mesh_tag}.json"


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             knobs: Optional[Dict] = None, save: bool = True,
             verbose: bool = True, device="cuda",
             n_layers: Optional[int] = None) -> Dict:
    cfg = get_config(arch)
    cell = SHAPES_BY_NAME[shape]
    if cell not in applicable_shapes(cfg):
        rec = {"arch": cfg.name, "shape": shape, "skipped": True,
               "reason": "full-attention arch skips long_500k (DESIGN.md §6)"}
        print(f"SKIP {arch} {shape}: {rec['reason']}")
        return rec
    rec = compile_cell(cfg, cell, knobs, multi_pod=multi_pod, device=device,
                       n_layers=n_layers, verbose=verbose)
    if save:
        ARTIFACTS.mkdir(parents=True, exist_ok=True)
        out = _artifact(arch, shape, rec["mesh"], multi_pod)
        out.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth to cut to (default: what fits the card)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in ARCH_IDS:
            cfg = get_config(a)
            for cell in applicable_shapes(cfg):
                cells.append((a, cell.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]
    mesh_tag = "1xH100" if resolve_device(args.device).type == "cuda" \
        else "1xCPU"

    failures = []
    for mp in meshes:
        for arch, shape in cells:
            tag = f"{arch} {shape} {mesh_tag}{' multi-pod' if mp else ''}"
            if args.skip_existing and _artifact(arch, shape, mesh_tag,
                                                mp).exists():
                print(f"SKIP (cached) {tag}")
                continue
            print(f"=== {tag} ===", flush=True)
            try:
                rec = run_cell(arch, shape, multi_pod=mp, verbose=False,
                               device=args.device, n_layers=args.layers)
                if not rec.get("skipped"):
                    r, mem = rec["roofline"], rec["memory"]
                    mfu, peak = rec["mfu"], mem["max_memory_allocated_gb"]
                    print(f"  ok n_layers={rec['n_layers']} "
                          f"compile={rec['compile_s']:.2f}s "
                          f"measured={rec['measured_step_s']:.4f}s "
                          f"tokens/s={rec['tokens_per_s']:.1f} "
                          f"mfu={'n/a' if mfu is None else f'{mfu:.4f}'} "
                          f"roofline step={r['step_s']:.4f}s "
                          f"dominant={r['dominant']} "
                          f"(c={r['compute_s']:.4f} m={r['memory_s']:.4f} "
                          f"x={r['collective_s']:.4f}) "
                          f"peak={'n/a' if peak is None else f'{peak:.2f}'}"
                          f" GiB (estimated {mem['estimated_gb']:.2f}) "
                          f"reduced={rec['reduced']}", flush=True)
            except Exception as e:
                failures.append((tag, repr(e)))
                print(f"  FAIL: {e}\n{traceback.format_exc()}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nall cells ran")


if __name__ == "__main__":
    main()
