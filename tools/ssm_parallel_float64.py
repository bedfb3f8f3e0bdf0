#!/usr/bin/env python3
"""The SSM families' sharded train step against one process, in float64.

    PYTHONPATH=src python3 tools/ssm_parallel_float64.py    # CPU, ~2 min

In float32 the sharded step of xlstm-1.3b's and jamba's smoke stacks
meets the one-process step only to the stacks' own amplification of a
rounding difference (``tests/test_torch_ssm_parallel.py``: up to ~1e-3 of
a leaf for the xLSTM).  This script shows that the difference is rounding
and not the layout: it runs both steps with every float32 of the port
computed in float64 (before anything of the port is imported, in this
process and in every rank it spawns, ``torch.float32`` names float64,
``Tensor.float()`` converts to float64 and float64 is the default dtype),
on gloo worlds on the CPU (``launch.mesh.spawn``), and prints for each
case the loss's relative gap and the worst gradient leaf's relative L2
gap.  The port's own initial weights (seed 0), a global batch of 4
sequences of 16 tokens (seed 1), microbatch 1.  Imports nothing of JAX.
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
from repro_torch.models.common import (tree_flatten,  # noqa: E402
                                       tree_unflatten)
from repro_torch.models.model import Model, gather_tree  # noqa: E402
from repro_torch.runconfig import runconfig_from_knobs  # noqa: E402
from repro_torch.train import train_loop as ttl  # noqa: E402

KNOBS = dict(param_dtype="float32", activation_dtype="float32",
             kv_cache_dtype="float32", microbatch=1)
CASES = [(arch, mesh, knobs)
         for arch in ("xlstm-1.3b", "jamba-1.5-large-398b")
         for mesh, knobs in (((1, 2), {}), ((2, 2), {}), ((1, 4), {}),
                             ((1, 2), {"sequence_parallel": True}),
                             ((1, 4), {"sequence_parallel": True}),
                             ((2, 2), {"tensor_parallel": False}),
                             ((2, 2), {"fsdp_shard_params": False}),
                             ((2, 2), {"remat_policy": "block"}))]
B, S = 4, 16


def _load(spec):
    model = Model(get_smoke_config(spec["arch"]), device="cpu")
    rc = runconfig_from_knobs(spec["knobs"])
    treedef = tree_flatten(model.param_shapes(torch.float32))[1]
    with np.load(spec["data"]) as z:
        params = tree_unflatten(treedef, [
            torch.from_numpy(z[f"param_{i}"]) for i in range(spec["n"])])
        batch = {k: torch.from_numpy(z[k]) for k in ("tokens", "labels")}
    return model, rc, params, batch


def rank(mesh, spec_path, out_path):
    """One rank: its blocks of the state, its rows of the batch, and the
    gathered gradients (written by rank 0)."""
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    model, rc, params, batch = _load(spec)
    state = ttl.shard_state(model, rc, params, mesh)
    pls = ttl.param_placements(model, rc)
    loss, _, grads = ttl.step_grads(model, state.params,
                                    ttl.rank_batch(batch, rc, mesh), rc,
                                    placements=pls)
    grads = gather_tree(grads, pls)
    if mesh.rank == 0:
        np.savez(out_path, loss=float(loss), **{
            f"g{i}": g.detach().numpy()
            for i, g in enumerate(tree_flatten(grads)[0])})


def main():
    if torch.tensor(1.0).float().dtype != torch.float64:
        sys.exit("the float64 patch did not take")
    tmp = tempfile.mkdtemp(prefix="ssm-f64-")
    print("arch mesh knobs: loss gap, worst leaf gap (relative L2)",
          flush=True)
    for arch, mesh, knobs in CASES:
        model = Model(get_smoke_config(arch), device="cpu")
        leaves = tree_flatten(model.init(0, dtype=torch.float32))[0]
        rng = np.random.default_rng(1)
        toks = rng.integers(1, model.cfg.vocab_size, size=(B, S + 1))
        data = os.path.join(tmp, "data.npz")
        np.savez(data, tokens=toks[:, :-1].astype(np.int32),
                 labels=toks[:, 1:].astype(np.int32),
                 **{f"param_{i}": x.numpy() for i, x in enumerate(leaves)})
        spec = {"arch": arch, "knobs": {**KNOBS, **knobs}, "data": data,
                "n": len(leaves)}
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        out = os.path.join(tmp, "out.npz")
        spawn(rank, mesh, (spec_path, out), device="cpu", timeout_s=300)
        m, rc, params, batch = _load(spec)
        loss, _, grads = ttl.step_grads(m, params, batch, rc,
                                        mesh={"data": mesh[0]})
        with np.load(out) as z:
            gap = abs(float(z["loss"]) - float(loss)) / abs(float(loss))
            worst = max(
                float(np.linalg.norm(z[f"g{i}"] - g.numpy())
                      / max(np.linalg.norm(g.numpy()), 1e-300))
                for i, g in enumerate(tree_flatten(grads)[0]))
        print(f"{arch} {mesh[0]}x{mesh[1]} {json.dumps(knobs)}: "
              f"{gap:.3e}, {worst:.3e}", flush=True)


if __name__ == "__main__":
    main()
