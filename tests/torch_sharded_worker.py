"""What each rank of a spawned process mesh runs for
``test_torch_sharded_step.py`` (spawned processes import it by name; it
imports no JAX).

``run_cases(mesh, spec_path, out_path)``: for every case of the spec,
this rank's blocks of the case's float32 parameters
(``train_loop.shard_state``), its data rank's slice of the global batch
(``data.data_slice``), the accumulated gradients (``step_grads``) and one
``make_train_step`` step.  Rank 0 writes the metrics, the gathered
gradients and the gathered new state to ``out_path`` (``.npz``, leaves in
``tree_flatten`` order), and whether the new state built on its host by
``gather_tree_to_host`` (a checkpoint's save) equals the gathered one."""

import json

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.common import tree_flatten, tree_unflatten
from repro_torch.models.model import Model, gather_tree, gather_tree_to_host
from repro_torch.runconfig import runconfig_from_knobs
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl
from repro_torch.train.data import data_slice


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def load_case(spec, device="cpu"):
    """(model, rc, global params, global batch) of one case."""
    model = Model(get_smoke_config(spec["arch"]), device=device)
    rc = runconfig_from_knobs(spec["knobs"])
    shapes, treedef = tree_flatten(model.param_shapes(torch.float32))
    with np.load(spec["data"]) as z:
        params = tree_unflatten(treedef, [
            torch.from_numpy(z[f"param_{i}"]) for i in range(len(shapes))])
        batch = {k: torch.from_numpy(z[f"batch_{k}"]) for k in spec["batch"]}
    return model, rc, params, batch


def run_cases(mesh, spec_path, out_path):
    torch.set_num_threads(1)
    with open(spec_path) as f:
        cases = json.load(f)
    out = {}
    for spec in cases:
        model, rc, params, batch = load_case(spec)
        state = ttl.shard_state(model, rc, params, mesh)
        local = data_slice(batch, mesh.coords["data"], mesh.shape["data"])
        pls = ttl.param_placements(model, rc)
        _, _, grads = ttl.step_grads(model, state.params, local, rc,
                                     placements=pls)
        grads = gather_tree(grads, pls)
        step = ttl.make_train_step(
            model, rc, lr_schedule=topt.cosine_schedule(1e-3, 0, 100))
        new_local, mets = step(state, local)
        spls = ttl.state_placements(model, rc)
        new = gather_tree(new_local, spls)
        host = gather_tree_to_host(new_local, spls, mesh)
        name = spec["name"]
        if mesh.rank == 0:
            out[f"{name}/host_equal"] = np.bool_(all(
                torch.equal(h, g) for h, g in zip(tree_flatten(host)[0],
                                                  tree_flatten(new)[0])))
        elif host is not None:
            raise AssertionError("gather_tree_to_host off rank 0")
        for k, v in mets.items():
            out[f"{name}/met_{k}"] = np.float32(v)
        for i, g in enumerate(tree_flatten(grads)[0]):
            out[f"{name}/grad_{i}"] = _np(g)
        for i, x in enumerate(tree_flatten(new)[0]):
            out[f"{name}/state_{i}"] = _np(x)
    if mesh.rank == 0:
        np.savez(out_path, **out)
