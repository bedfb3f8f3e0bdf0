"""End-to-end training launcher (from ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
        --device cpu --steps 20 [--ckpt-dir DIR --resume] [--knob k=v ...]

The flags are the reference launcher's plus ``--device`` (default
``cuda``; ``cpu`` runs on the host).  It integrates the runtime: RunConfig
knobs, the microbatched train step, the stateless data stream (made on
the device), checkpoints with auto-resume (the reference's layout: either
package resumes the other's), and the step-time watchdog feeding the
elastic policy.  It prints the reference's ``step … loss … gnorm … lr …``
lines.  Weights are random bf16, made on the device from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import parse_knobs
from repro_torch.models.model import Model
from repro_torch.runconfig import runconfig_from_knobs
from repro_torch.train import elastic
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.train_loop import init_state, make_train_step


def main(argv=None):
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
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit("launch.train drives the decoder LMs' token stream;"
                         " whisper trains through Model.loss with frames")
    rc = runconfig_from_knobs(parse_knobs(args.knob))
    mesh = make_host_mesh(args.device)
    model = Model(cfg, device=mesh.devices[0])

    cm = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    watchdog = elastic.StepWatchdog()

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
    t_last = time.monotonic()
    for i in range(start, args.steps):
        batch = next(data)
        state, mets = step_fn(state, batch)
        now = time.monotonic()
        watchdog.observe(0, now - t_last)
        t_last = now
        if (i + 1) % 10 == 0 or i == start:
            print(f"step {i+1:5d} loss {float(mets['loss']):.4f} "
                  f"gnorm {float(mets['grad_norm']):.3f} "
                  f"lr {float(mets['lr']):.2e}", flush=True)
        if cm and (i + 1) % args.ckpt_every == 0:
            cm.save(i + 1, state, blocking=False)
    if cm:
        cm.save(args.steps, state, blocking=True)
        print(f"final checkpoint at step {args.steps} -> {cm.root}")
    print("done")


if __name__ == "__main__":
    main()
