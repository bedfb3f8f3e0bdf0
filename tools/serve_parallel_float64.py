#!/usr/bin/env python3
"""The SSM families' prefill and decode under a mesh against one process,
in float64.

    PYTHONPATH=src python3 tools/serve_parallel_float64.py    # CPU, ~1 min

In float32 the sharded serving of xlstm-1.3b's and jamba's smoke stacks
meets the one-process run only to the stacks' own amplification of a
rounding difference (``tests/test_torch_serve_parallel.py``: up to ~2e-4
of a leaf for jamba).  This script shows that the difference is rounding
and not the layout: it runs both with every float32 of the port computed
in float64 (before anything of the port is imported, in this process and
in every rank it spawns, ``torch.float32`` names float64,
``Tensor.float()`` converts to float64 and float64 is the default dtype),
on gloo worlds on the CPU (``launch.mesh.spawn``), and prints for each
case the worst relative L2 gap over the prefill's and the 4 decode
steps' logits and every cache and state leaf after each.  The port's own
initial weights (seed 0), 4 prompts of 8 tokens (1 under
``shard_kv_seq``; seed 1), a cache of 16.  Imports nothing of JAX.
"""

import torch

torch.float32 = torch.float64
torch.Tensor.float = lambda self, *a, **k: self.double(*a, **k)
torch.set_default_dtype(torch.float64)

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.common import (tree_flatten,  # noqa: E402
                                       tree_unflatten)
from repro_torch.models.model import (Model,  # noqa: E402
                                      decode_state_placements, gather_tree,
                                      shard_tree)
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel.sharding import batch_axes  # noqa: E402
from repro_torch.runconfig import runconfig_from_knobs  # noqa: E402
from repro_torch.train import train_loop as ttl  # noqa: E402

KNOBS = dict(param_dtype="float32", activation_dtype="float32",
             kv_cache_dtype="float32")
CASES = [(arch, mesh, knobs)
         for arch in ("xlstm-1.3b", "jamba-1.5-large-398b")
         for mesh, knobs in (((2, 1), {}), ((1, 2), {}), ((2, 2), {}),
                             ((1, 4), {}),
                             ((1, 4), {"sequence_parallel": True}),
                             ((2, 2), {"shard_kv_seq": True}))]
S, N, S_MAX = 8, 4, 16


def _load(spec):
    model = Model(get_smoke_config(spec["arch"]), device="cpu")
    rc = runconfig_from_knobs(spec["knobs"])
    treedef = tree_flatten(model.param_shapes(torch.float32))[1]
    with np.load(spec["data"]) as z:
        params = tree_unflatten(treedef, [
            torch.from_numpy(z[f"param_{i}"]) for i in range(spec["n"])])
        tokens = torch.from_numpy(z["tokens"])
    return model, rc, params, tokens


def _serve(model, rc, params, tokens, mesh=None, batch=None):
    """Every output of the run: the logits and the state's leaves after
    the prefill and after each decode step (gathered on a mesh)."""
    outs = []

    def keep(logits, state):
        if mesh is not None:
            rows = transformer.serve_rows(batch, rc, mesh)
            if rows.stop - rows.start < batch:
                logits = collectives.gather(logits, 0,
                                            batch_axes(rc.shard, mesh), mesh)
            state = gather_tree(state, decode_state_placements(
                model, batch, S_MAX, rc, mesh))
        outs.extend(x.detach().double().numpy().copy()
                    for x in [logits] + tree_flatten(state)[0])
    with torch.no_grad():
        logits, state = model.prefill(params, {"tokens": tokens[:, :S]},
                                      S_MAX, rc, batch=batch)
        keep(logits, state)
        for t in range(N):
            logits, state = model.decode_step(
                params, tokens[:, S + t:S + t + 1], state, rc)
            keep(logits, state)
    return outs


def rank(mesh, spec_path, out_path):
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    model, rc, params, tokens = _load(spec)
    B = tokens.shape[0]
    local = shard_tree(params, ttl.param_placements(model, rc, mesh),
                       mesh.rank)
    outs = _serve(model, rc, local, tokens[transformer.serve_rows(
        B, rc, mesh)], mesh, B)
    if mesh.rank == 0:
        np.savez(out_path, **{f"o{i}": x for i, x in enumerate(outs)})


def main():
    if torch.tensor(1.0).float().dtype != torch.float64:
        sys.exit("the float64 patch did not take")
    tmp = tempfile.mkdtemp(prefix="serve-f64-")
    print("arch mesh knobs: worst gap over the logits and every leaf "
          "(relative L2)", flush=True)
    for arch, mesh, knobs in CASES:
        model = Model(get_smoke_config(arch), device="cpu")
        leaves = tree_flatten(model.init(0, dtype=torch.float32))[0]
        rng = np.random.default_rng(1)
        B = 1 if knobs.get("shard_kv_seq") else 4
        toks = rng.integers(1, model.cfg.vocab_size, size=(B, S + N))
        data = os.path.join(tmp, "data.npz")
        np.savez(data, tokens=toks.astype(np.int32),
                 **{f"param_{i}": x.numpy() for i, x in enumerate(leaves)})
        spec = {"arch": arch, "knobs": {**KNOBS, **knobs}, "data": data,
                "n": len(leaves)}
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        out = os.path.join(tmp, "out.npz")
        spawn(rank, mesh, (spec_path, out), device="cpu", timeout_s=300)
        want = _serve(*_load(spec))
        with np.load(out) as z:
            worst = max(
                float(np.linalg.norm(z[f"o{i}"].astype(np.float64) - w)
                      / max(np.linalg.norm(w.astype(np.float64)), 1e-300))
                for i, w in enumerate(want))
        print(f"{arch} {mesh[0]}x{mesh[1]} {json.dumps(knobs)}: "
              f"{worst:.3e}", flush=True)


if __name__ == "__main__":
    main()
