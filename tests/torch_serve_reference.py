"""The reference's prefill and decode steps under a mesh, run in a process
of its own.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python tests/torch_serve_reference.py SPEC.json OUT.npz

``XLA_FLAGS`` must be set before JAX is imported, so
``test_torch_serve_parallel.py`` starts this script as a subprocess.
``SPEC.json`` lists the runs: each names an architecture's smoke config,
RunConfig knobs, a (data, model) mesh, the prompt's length, the decode
steps, the cache length and the ``.npz`` holding its float32 parameters
and the global tokens.  Each run places the parameters and the decode
state as the reference's ``launch.dryrun.lower_cell`` places them
(``shardings_for(param_axes / decode_state_axes, rc.shard.resolve(mesh))``)
on ``jax.sharding.Mesh(devices.reshape(D, M), ("data", "model"))`` (the
auto-axis mesh), the tokens over ``("batch", "seq")`` under the same
guard, and runs a jitted ``Model.prefill`` and ``decode`` jitted
``Model.decode_step`` s under ``with mesh:``.  ``OUT.npz`` holds, per
run, each step's logits and every leaf of the decode state after the
prefill and after the last step (``jax.tree`` order, float32).
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs import get_smoke_config
from repro.models.model import Model
from repro.parallel.sharding import shardings_for
from repro.runconfig import runconfig_from_knobs


def _f32(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def run(spec, data):
    D, M = spec["mesh"]
    mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M),
                ("data", "model"))
    jm = Model(get_smoke_config(spec["arch"]))
    rc = runconfig_from_knobs(spec["knobs"])
    rules = rc.shard.resolve(mesh)
    shapes = jm.param_shapes(jnp.float32)
    params = jax.tree.unflatten(
        jax.tree.structure(shapes),
        [jnp.asarray(data[f"param_{i}"]) for i in range(spec["n_params"])])
    params = jax.device_put(params, shardings_for(
        params, jm.param_axes(), rules, mesh))
    toks = jnp.asarray(data["batch_tokens"])
    B, S, n, s_max = (spec["global_batch"], spec["prompt"], spec["decode"],
                      spec["s_max"])
    st_sh = shardings_for(jm.decode_state_shapes(B, s_max, rc),
                          jm.decode_state_axes(rc), rules, mesh)

    def rows(x):
        return jax.device_put(x, shardings_for(x, ("batch", "seq"), rules,
                                               mesh))
    out = {}
    with mesh:
        prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, s_max,
                                                  rc))
        logits, state = prefill(params, rows(toks[:, :S]))
        out["logits_0"] = np.asarray(logits, np.float32)
        for i, x in enumerate(_f32(state)):
            out[f"prefill_{i}"] = x
        step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, rc))
        for t in range(n):
            state = jax.device_put(state, st_sh)
            logits, state = step(params, rows(toks[:, S + t:S + t + 1]),
                                 state)
            out[f"logits_{t + 1}"] = np.asarray(logits, np.float32)
        for i, x in enumerate(_f32(state)):
            out[f"decode_{i}"] = x
    return out


def main(spec_path, out_path):
    with open(spec_path) as f:
        runs = json.load(f)
    out = {}
    for r in runs:
        with np.load(r["data"]) as data:
            for k, v in run(r, data).items():
                out[f"{r['name']}/{k}"] = v
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
