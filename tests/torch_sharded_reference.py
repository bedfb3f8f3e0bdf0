"""The reference's sharded train step, run in a process of its own.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python tests/torch_sharded_reference.py SPEC.json OUT.npz

``XLA_FLAGS`` must be set before JAX is imported, so the tests that hold
the port's sharded step against the reference's start this script as a
subprocess (``test_torch_sharded_step.py``).  ``SPEC.json`` lists the
runs: each names an architecture's smoke config (with the run's ``cfg``
fields replaced, and cut to the pattern positions ``keep``, when it
names them), RunConfig knobs, a (data, model) mesh, and the ``.npz``
holding its float32 parameters and its global batch.  Each run places
the state as the reference's launcher does (``shardings_for(state_axes,
rc.shard.resolve(mesh))``) on ``jax.sharding.Mesh(devices.reshape(D, M),
("data", "model"))``: the auto-axis mesh (``jax.make_mesh``'s explicit
axes refuse the embedding gather) and takes one jitted
``make_train_step`` step under ``with mesh:``.  ``OUT.npz`` holds, per
run, the metrics and every leaf of the new state (``jax.tree`` order).
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import get_smoke_config
from repro.models.model import Model
from repro.parallel.sharding import shardings_for
from repro.runconfig import runconfig_from_knobs
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl


def run(spec, data):
    D, M = spec["mesh"]
    mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M),
                ("data", "model"))
    cfg = dataclasses.replace(get_smoke_config(spec["arch"]),
                              **spec.get("cfg", {}))
    keep = spec.get("keep")
    if keep:                 # a depth cut: the pattern positions kept
        cfg = cfg.scaled(n_layers=len(keep),
                         pattern=tuple(cfg.pattern[i] for i in keep))
    jm = Model(cfg)
    rc = runconfig_from_knobs(spec["knobs"])
    params = jax.tree.unflatten(
        jax.tree.structure(jax.eval_shape(
            lambda: jm.init(jax.random.key(0), jnp.float32))),
        [jnp.asarray(data[f"param_{i}"]) for i in range(spec["n_params"])])
    state = jtl.TrainState(params, jopt.opt_init(params, rc),
                           jnp.zeros((), jnp.int32))
    state = jax.device_put(state, shardings_for(
        state, jtl.state_axes(jm, rc), rc.shard.resolve(mesh), mesh))
    batch = {}
    for key in spec["batch"]:
        spec_b = P(None, "data") if key == "positions" else P("data")
        batch[key] = jax.device_put(jnp.asarray(data[f"batch_{key}"]),
                                    NamedSharding(mesh, spec_b))
    with mesh:
        step = jax.jit(jtl.make_train_step(
            jm, rc, lr_schedule=jopt.cosine_schedule(1e-3, 0, 100)))
        new, met = step(state, batch)
    out = {f"met_{k}": np.asarray(v, np.float32) for k, v in met.items()}
    for i, leaf in enumerate(jax.tree.leaves(new)):
        out[f"state_{i}"] = np.asarray(leaf)
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
