"""What each rank of a spawned process mesh runs for
``test_torch_sharded_step.py`` (spawned processes import it by name; it
imports no JAX).

``run_cases(mesh, spec_path, out_path)``: for every case of the spec,
this rank's blocks of the case's float32 parameters
(``train_loop.shard_state``), its rows of the global batch
(``train_loop.rank_batch``: its data rank's block of each microbatch), the accumulated gradients (``step_grads``) and one
``make_train_step`` step.  Rank 0 writes the metrics, the gathered
gradients and the gathered new state to ``out_path`` (``.npz``, leaves in
``tree_flatten`` order), and whether the new state built on its host by
``gather_tree_to_host`` (a checkpoint's save) equals the gathered one.

``count_cases(mesh, spec_path, out_path)`` (``test_torch_virtual_mesh.py``):
for every case, this rank's state drawn block by block
(``train_loop.init_local_state``) and one ``make_train_step`` step on
its rows of the batch under ``launch.roofline.count_step``.  Rank 0
writes its counts (FLOPs, collective bytes by kind, each state leaf's
shape and bytes) and the step's loss to ``out_path`` (JSON).

``serve_cases(mesh, spec_path, out_path)``
(``test_torch_serve_parallel.py``): for every case, this rank's blocks of
the case's float32 parameters, ``Model.prefill`` of its rows of the
global prompt (``transformer.serve_rows``), then ``n_decode``
``Model.decode_step`` s on its rows of the following tokens.  Rank 0
writes the logits (gathered over the data axes where the batch is split)
and the decode state gathered after the prefill and after the last step
(``.npz``, leaves in ``tree_flatten`` order).

``serve_count_cases(mesh, spec_path, out_path)``
(``test_torch_virtual_mesh.py``): for every serving case, the rank's
parameters drawn block by block (``Model.init_blocks``) and one counted
prefill, or one counted decode step against a state from
``init_local_decode_state`` at ``pos = s_max - 1``; rank 0 writes the
counts as ``count_cases`` does."""

import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
from repro_torch.launch.roofline import count_step
from repro_torch.models.common import tree_flatten, tree_unflatten
from repro_torch.models import transformer
from repro_torch.models.model import (Model, decode_state_placements,
                                      gather_tree, gather_tree_to_host,
                                      init_local_decode_state, shard_tree)
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import batch_axes
from repro_torch.runconfig import runconfig_from_knobs
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl


def state_counts(state) -> dict:
    """Each state leaf's shape and the state's bytes."""
    leaves = tree_flatten(state)[0]
    return {"shapes": [list(t.shape) for t in leaves],
            "bytes": sum(t.numel() * t.element_size() for t in leaves)}


def count_case(spec, batch):
    """(counts, loss) of one counted step of a case on the ambient mesh,
    from the state ``init_local_state`` draws and this rank's ``batch``.
    The counts also hold the flash wrapper's calls and launch counters
    and the mLSTM wrapper's calls (its q's shape: no launch on the CPU, a
    wrapper given CPU tensors runs its plain version)."""
    model = Model(get_smoke_config(spec["arch"]), device="cpu")
    rc = runconfig_from_knobs(spec["knobs"])
    state = ttl.init_local_state(model, 0, rc)
    held = state_counts(state)
    step = ttl.make_train_step(model, rc)
    calls, fn = [], flash_ops.flash_attention
    m_calls, m_fn = [], mlstm_ops.mlstm_chunk

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return fn(q, k, v, **kw)

    def m_counted(q, k, v, *args, **kw):
        m_calls.append(tuple(q.shape))
        return m_fn(q, k, v, *args, **kw)
    flash_ops.reset_launch_counts()
    flash_ops.flash_attention = counted
    mlstm_ops.mlstm_chunk = m_counted
    try:
        counts, (_, mets) = count_step(lambda: step(state, batch))
    finally:
        flash_ops.flash_attention = fn
        mlstm_ops.mlstm_chunk = m_fn
    launches = {k: getattr(flash_ops, k) for k in (
        "launches", "launches_wgmma", "launches_fma", "launches_bwd")}
    return {"flops": counts.flops, "coll_by_kind": counts.coll_by_kind,
            "flash_calls": [list(map(list, c)) for c in calls],
            "mlstm_calls": [list(c) for c in m_calls],
            "launches": launches, **held}, float(mets["loss"])


def count_cases(mesh, spec_path, out_path):
    torch.set_num_threads(1)
    with open(spec_path) as f:
        cases = json.load(f)
    out = {}
    for spec in cases:
        with np.load(spec["data"]) as z:
            batch = {k: torch.from_numpy(z[f"batch_{k}"])
                     for k in spec["batch"]}
        rc = runconfig_from_knobs(spec["knobs"])
        counts, loss = count_case(spec, ttl.rank_batch(batch, rc, mesh))
        out[spec["name"]] = {**counts, "loss": loss}
    if mesh.rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)


def _np(x: torch.Tensor) -> np.ndarray:
    """A float32 copy (a leaf updated in place later keeps this value)."""
    return x.detach().float().numpy().copy()


def case_config(spec):
    """The case's smoke config, with the spec's ``cfg`` fields replaced
    (a shape no smoke config has), cut to the pattern positions ``keep``
    when the spec names them (one group each, as
    ``test_torch_train._cut`` cuts it)."""
    cfg = dataclasses.replace(get_smoke_config(spec["arch"]),
                              **spec.get("cfg", {}))
    keep = spec.get("keep")
    if keep:
        cfg = cfg.scaled(n_layers=len(keep),
                         pattern=tuple(cfg.pattern[i] for i in keep))
    return cfg


def load_case(spec, device="cpu"):
    """(model, rc, global params, global batch) of one case."""
    model = Model(case_config(spec), device=device)
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
        local = ttl.rank_batch(batch, rc, mesh)
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


def _gather_rows(x, rc, mesh, batch):
    """The global batch's rows of ``x`` (this rank's rows, dimension 0)
    where the batch is split over the data axes; ``x`` where every data
    rank holds every row."""
    rows = transformer.serve_rows(batch, rc, mesh)
    if rows.stop - rows.start == batch:
        return x
    return collectives.gather(x, 0, batch_axes(rc.shard, mesh), mesh)


def serve_cases(mesh, spec_path, out_path):
    torch.set_num_threads(1)
    with open(spec_path) as f:
        cases = json.load(f)
    out = {}
    for spec in cases:
        model, rc, params, batch = load_case(spec)
        name, B = spec["name"], spec["global_batch"]
        local = shard_tree(params, ttl.param_placements(model, rc, mesh),
                           mesh.rank)
        tokens = batch["tokens"][transformer.serve_rows(B, rc, mesh)]
        S, n = spec["prompt"], spec["decode"]
        pls = decode_state_placements(model, B, spec["s_max"], rc, mesh)
        with torch.no_grad():
            logits, state = model.prefill(local, {"tokens": tokens[:, :S]},
                                          spec["s_max"], rc, batch=B)
            out[f"{name}/logits_0"] = _np(_gather_rows(logits, rc, mesh, B))
            for i, x in enumerate(tree_flatten(gather_tree(state, pls))[0]):
                out[f"{name}/prefill_{i}"] = _np(x)
            for t in range(n):
                logits, state = model.decode_step(
                    local, tokens[:, S + t:S + t + 1], state, rc)
                out[f"{name}/logits_{t + 1}"] = _np(
                    _gather_rows(logits, rc, mesh, B))
            for i, x in enumerate(tree_flatten(gather_tree(state, pls))[0]):
                out[f"{name}/decode_{i}"] = _np(x)
    if mesh.rank == 0:
        np.savez(out_path, **out)


def serve_count_case(spec, mesh):
    """(counts, logits) of one counted serving step of a case on ``mesh``
    (the ambient one): the rank's parameter blocks drawn by
    ``init_blocks``, its rows of the prompt (prefill) or of one token
    against an empty state at ``pos = s_max - 1`` (decode); the flash and
    mLSTM wrappers' calls counted as ``count_case`` counts them."""
    model = Model(case_config(spec), device="cpu")
    rc = runconfig_from_knobs(spec["knobs"])
    B, S = spec["global_batch"], spec["s_max"]
    params = model.init_blocks(0, ttl.param_placements(model, rc, mesh),
                               mesh.rank, dtype=torch.float32)
    rows = transformer.serve_rows(B, rc, mesh)
    with np.load(spec["data"]) as z:
        tokens = torch.from_numpy(z["batch_tokens"])[rows]
    if spec["mode"] == "prefill":
        def step():
            return model.prefill(params, {"tokens": tokens[:, :S]}, S, rc,
                                 batch=B)
        held = state_counts(params)
    else:
        state = init_local_decode_state(model, B, S, rc, mesh)
        state = state._replace(pos=torch.full_like(state.pos, S - 1))
        held = state_counts((params, state))

        def step():
            return model.decode_step(params, tokens[:, :1], state, rc)
    calls, fn = [], flash_ops.flash_attention
    m_calls, m_fn = [], mlstm_ops.mlstm_chunk

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return fn(q, k, v, **kw)

    def m_counted(q, k, v, *args, **kw):
        m_calls.append(tuple(q.shape))
        return m_fn(q, k, v, *args, **kw)
    flash_ops.flash_attention = counted
    mlstm_ops.mlstm_chunk = m_counted
    try:
        with torch.no_grad():
            counts, (logits, _) = count_step(step)
    finally:
        flash_ops.flash_attention = fn
        mlstm_ops.mlstm_chunk = m_fn
    return {"flops": counts.flops, "coll_by_kind": counts.coll_by_kind,
            "flash_calls": [list(map(list, c)) for c in calls],
            "mlstm_calls": [list(c) for c in m_calls],
            "logits_shape": list(logits.shape), **held}, logits


def serve_count_cases(mesh, spec_path, out_path):
    torch.set_num_threads(1)
    with open(spec_path) as f:
        cases = json.load(f)
    out = {}
    for spec in cases:
        counts, logits = serve_count_case(spec, mesh)
        out[spec["name"]] = {**counts,
                             "finite": bool(torch.isfinite(logits).all())}
    if mesh.rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)
