"""End-to-end training launcher (from ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
        --device cpu --steps 20 [--ckpt-dir DIR --resume] [--knob k=v ...] \
        [--mesh 2x2]

The flags are the reference launcher's plus ``--device`` (default
``cuda``; ``cpu`` runs on the host) and ``--mesh DxM`` (or ``PxDxM``):
D·M processes on a (data, model) mesh, spawned through a ``file://``
store (a rank that fails or hangs in a collective stops the run), the
backend chosen from the device and the card count and printed (NCCL
when every rank has a card, else gloo, the ranks sharing card 0 or the
host).  It integrates
the runtime: RunConfig knobs (the layout knobs place the state on a
mesh), the microbatched train step, the stateless data stream (made on
the device; on a mesh each data rank draws its rows of the global
batch), checkpoints with auto-resume (the reference's layout, either
package resumes the other's, and a mesh's checkpoint resumes on any
mesh or on one process: rank 0 builds the global state on its host one
leaf at a time and saves it, and each rank reads its own blocks, one
leaf at a time), and the step-time watchdog feeding the elastic
policy.  It prints the reference's ``step … loss … gnorm … lr …`` lines.  Weights
are random bf16, made on the device from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import backend_for, make_host_mesh, spawn
from repro_torch.launch.serve import parse_knobs
from repro_torch.models.model import Model, gather_tree_to_host
from repro_torch.parallel.sharding import batch_axes, data_parallel_size
from repro_torch.runconfig import runconfig_from_knobs
from repro_torch.train import elastic
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.train_loop import (init_state, make_train_step,
                                          shard_state, state_placements,
                                          state_shapes)


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--knob", action="append", default=[],
                    help="RunConfig override, e.g. --knob microbatch=2")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DxM (or PxDxM): train on a mesh of processes")
    return ap


def _config(args):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit("launch.train drives the decoder LMs' token stream;"
                         " whisper trains through Model.loss with frames")
    return cfg, runconfig_from_knobs(parse_knobs(args.knob))


def _loop(args, state, start, step_fn, data, cm, save, rank0):
    watchdog = elastic.StepWatchdog()
    t_last = time.monotonic()
    for i in range(start, args.steps):
        state, mets = step_fn(state, next(data))
        now = time.monotonic()
        watchdog.observe(0, now - t_last)
        t_last = now
        if rank0 and ((i + 1) % 10 == 0 or i == start):
            print(f"step {i+1:5d} loss {float(mets['loss']):.4f} "
                  f"gnorm {float(mets['grad_norm']):.3f} "
                  f"lr {float(mets['lr']):.2e}", flush=True)
        if cm and (i + 1) % args.ckpt_every == 0:
            save(i + 1, state, False)
    if cm:
        save(args.steps, state, True)
        if rank0:
            print(f"final checkpoint at step {args.steps} -> {cm.root}")


def _train_rank(mesh, args):
    """One rank of ``--mesh``: this rank's blocks of the state, its data
    rank's rows of every batch, the sharded step."""
    cfg, rc = _config(args)
    model = Model(cfg, device=mesh.device)
    rank0 = mesh.rank == 0
    placements = state_placements(model, rc, mesh)
    cm = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if cm and args.resume and cm.latest_step() is not None:
        state, start = cm.restore(state_shapes(model, rc),
                                  device=model.device,
                                  placements=placements, rank=mesh.rank)
        if rank0:
            print(f"resumed from step {start}")
    else:
        state = shard_state(model, rc, model.init(args.seed), mesh)

    def save(step, state, blocking):
        full = gather_tree_to_host(state, placements, mesh)  # all join
        if rank0:
            cm.save(step, full, blocking=blocking)

    d_index, shape = 0, mesh.shape
    for a in batch_axes(rc.shard, mesh):
        d_index = d_index * shape[a] + mesh.coords[a]
    data = SyntheticDataset(args.seed, args.global_batch, args.seq_len,
                            cfg.vocab_size, start_step=start,
                            data_index=d_index,
                            data_count=data_parallel_size(rc.shard),
                            device=model.device)
    step_fn = make_train_step(model, rc, lr_schedule=lambda s: args.lr,
                              donate=True)
    _loop(args, state, start, step_fn, data, cm, save, rank0)
    if rank0:
        print("done")


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.lower().split("x"))
        world = 1
        for n in shape:
            world *= n
        backend = backend_for(args.device, world)
        print(f"mesh {args.mesh}: {world} processes over {backend}",
              flush=True)
        spawn(_train_rank, shape, (args,), device=args.device,
              backend=backend)
        return
    cfg, rc = _config(args)
    mesh = make_host_mesh(args.device)
    model = Model(cfg, device=mesh.devices[0])

    cm = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    state = init_state(model, args.seed, rc)
    start = 0
    if cm and args.resume and cm.latest_step() is not None:
        state, start = cm.restore(state)
        print(f"resumed from step {start}")
    step_fn = make_train_step(model, rc, lr_schedule=lambda s: args.lr,
                              mesh=mesh.shape, donate=True)
    data = SyntheticDataset(args.seed, args.global_batch, args.seq_len,
                            cfg.vocab_size, start_step=start,
                            device=model.device)
    _loop(args, state, start, step_fn, data, cm,
          lambda step, state, blocking: cm.save(step, state,
                                                blocking=blocking), True)
    print("done")


if __name__ == "__main__":
    main()
