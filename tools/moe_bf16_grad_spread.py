#!/usr/bin/env python3
"""How far a bf16 train step's gradients move between a mesh and one
device, in the reference and in the port, on the CPU.

    PYTHONPATH=src python3 tools/moe_bf16_grad_spread.py     # ~4 min

qwen2-moe-a2.7b's smoke config in bf16 (parameters and activations, the
reference's weights from seed 0, a global batch of 4 sequences of 16
tokens, microbatch 1, the dense MoE) as it routes (top 2 of 8 experts,
where a rounding difference can flip a token's routing) and with every
expert routed (top 8 of 8: no routing to flip), and yi-6b's (no MoE):
each package's step on a (data, model) mesh of 2 x 2 and of 1 x 2
against its own step on one device: the reference's jitted step on an
auto-axis mesh of forced CPU devices (a subprocess of this script,
``--reference``) and on one device, the port's on a gloo world
(``launch.mesh.spawn``) and in one process.  Printed per package and
mesh: the embedding's gradient gap and the worst other leaf's, in
relative L2.  The reference's gradient is read off AdamW's first moment,
unclipped by its reported norm.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# case: (arch, config fields replaced)
CASES = {"qwen2-moe top-2 of 8": ("qwen2-moe-a2.7b", {}),
         "qwen2-moe top-8 of 8": ("qwen2-moe-a2.7b",
                                  {"n_experts_per_tok": 8}),
         "yi-6b": ("yi-6b", {})}
MESHES = ((2, 2), (1, 2))
KNOBS = dict(param_dtype="bfloat16", activation_dtype="bfloat16",
             kv_cache_dtype="bfloat16", learning_rate=1e-3, microbatch=1,
             moe_impl="dense")
B, S = 4, 16


def _batch(vocab):
    toks = np.random.default_rng(1).integers(1, vocab, size=(B, S + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def reference(out_path):
    """The reference's gradients on one device and on ``MESHES`` for every
    case, and the weights (as float32) the port starts from."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.models.model import Model
    from repro.parallel.sharding import shardings_for
    from repro.runconfig import runconfig_from_knobs
    from repro.train import optimizer as jopt
    from repro.train import train_loop as jtl

    out = {}
    rc = runconfig_from_knobs(KNOBS)
    for route, (arch, fields) in CASES.items():
        jm = Model(dataclasses.replace(get_smoke_config(arch), **fields))
        params = jm.init(jax.random.key(0), dtype=jnp.bfloat16)
        for i, leaf in enumerate(jax.tree.leaves(params)):
            out[f"{route}/param_{i}"] = np.asarray(leaf, np.float32)
        tokens, labels = _batch(jm.cfg.vocab_size)
        for D, M in ((1, 1),) + MESHES:
            mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M),
                        ("data", "model"))
            state = jtl.TrainState(params, jopt.opt_init(params, rc),
                                   jnp.zeros((), jnp.int32))
            state = jax.device_put(state, shardings_for(
                state, jtl.state_axes(jm, rc), rc.shard.resolve(mesh), mesh))
            batch = {k: jax.device_put(jnp.asarray(v),
                                       NamedSharding(mesh, P("data")))
                     for k, v in (("tokens", tokens), ("labels", labels))}
            with mesh:
                new, met = jax.jit(jtl.make_train_step(
                    jm, rc, lr_schedule=jopt.cosine_schedule(1e-3, 0, 100)))(
                        state, batch)
            unclip = max(1.0, float(met["grad_norm"]) / rc.grad_clip_norm)
            for i, m in enumerate(jax.tree.leaves(new.opt_state.m)):
                out[f"{route}/{D}x{M}/grad_{i}"] = \
                    np.asarray(m, np.float32) / (1 - rc.beta1) * unclip
    np.savez(out_path, **out)


def _load(route, data_path):
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_flatten, tree_unflatten
    from repro_torch.models.model import Model
    from repro_torch.runconfig import runconfig_from_knobs

    arch, fields = CASES[route]
    model = Model(dataclasses.replace(get_smoke_config(arch), **fields),
                  device="cpu")
    treedef = tree_flatten(model.param_shapes(torch.bfloat16))[1]
    with np.load(data_path) as z:
        n = sum(k.startswith(f"{route}/param_") for k in z)
        params = tree_unflatten(treedef, [
            torch.from_numpy(z[f"{route}/param_{i}"]).to(torch.bfloat16)
            for i in range(n)])
    tokens, labels = _batch(model.cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    return model, runconfig_from_knobs(KNOBS), params, batch


def port_rank(mesh, route, data_path, out_path):
    """One rank of the port's step on a mesh: the gathered gradients."""
    import torch

    from repro_torch.models.common import tree_flatten
    from repro_torch.models.model import gather_tree
    from repro_torch.train import train_loop as ttl

    torch.set_num_threads(1)
    model, rc, params, batch = _load(route, data_path)
    state = ttl.shard_state(model, rc, params, mesh)
    pls = ttl.param_placements(model, rc)
    _, _, grads = ttl.step_grads(model, state.params,
                                 ttl.rank_batch(batch, rc, mesh), rc,
                                 placements=pls)
    grads = gather_tree(grads, pls)
    if mesh.rank == 0:
        np.savez(out_path, **{f"grad_{i}": g.float().numpy() for i, g
                              in enumerate(tree_flatten(grads)[0])})


def _gaps(one, mesh, names):
    rel = [float(np.linalg.norm(m - o) / max(np.linalg.norm(o), 1e-30))
           for o, m in zip(one, mesh)]
    emb = names.index("embed/tok")
    worst = max((r, n) for i, (r, n) in enumerate(zip(rel, names))
                if i != emb)
    return rel[emb], worst


def main():
    if "--reference" in sys.argv:
        reference(sys.argv[-1])
        return
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.common import tree_flatten_with_path
    from repro_torch.train import train_loop as ttl

    tmp = tempfile.mkdtemp(prefix="moe-bf16-")
    ref_path = os.path.join(tmp, "reference.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, __file__, "--reference", ref_path],
                   env=env, check=True)
    ref = dict(np.load(ref_path))
    print(f"smoke configs, bf16, B={B} S={S}: a mesh against one device, "
          "relative L2 of each gradient leaf", flush=True)
    for route in CASES:
        model, rc, params, batch = _load(route, ref_path)
        for mesh in MESHES:
            _, _, grads = ttl.step_grads(model, params, batch, rc,
                                         mesh={"data": mesh[0]})
            pairs = tree_flatten_with_path(grads)[0]
            names = ["/".join(map(str, p)) for p, _ in pairs]
            one = [g.float().numpy() for _, g in pairs]
            out = os.path.join(tmp, "port.npz")
            spawn(port_rank, mesh, (route, ref_path, out), device="cpu",
                  timeout_s=300)
            with np.load(out) as z:
                got = [z[f"grad_{i}"] for i in range(len(one))]
            r1 = [ref[f"{route}/1x1/grad_{i}"] for i in range(len(one))]
            rm = [ref[f"{route}/{mesh[0]}x{mesh[1]}/grad_{i}"]
                  for i in range(len(one))]
            for who, a, b in (("port", one, got), ("reference", r1, rm)):
                emb, worst = _gaps(a, b, names)
                print(f"  {route}, {mesh[0]} x {mesh[1]}, {who}: embed/tok "
                      f"{emb:.3e}; worst other {worst[0]:.3e} ({worst[1]})",
                      flush=True)


if __name__ == "__main__":
    main()
