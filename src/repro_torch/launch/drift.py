"""Full-sequence forward against teacher-forced decode, position by position.

    PYTHONPATH=src python -m repro_torch.launch.drift --arch xlstm-1.3b \\
        --d-model 2048 --layers 8 --tokens 64 --device cpu [--w-rec-scale 0.1]

One prompt goes through ``transformer.forward`` (for xLSTM: the chunkwise
mLSTM kernel on the card, its plain version on the host) and through
``decode_step`` one token at a time (the sequential recurrences), with
float32 weights from ``--seed``.  The relative L2 distance of the two
logits is printed for every ``--every``-th position.  The same function
computed in two orders differs by float rounding; a recurrence that
amplifies rounding shows as a distance that grows with the position.
``--w-rec-scale`` multiplies the sLSTM recurrent weights after init.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.runconfig import RunConfig


def drift(model: Model, params, tokens, rc: RunConfig) -> torch.Tensor:
    """tokens [1,S] -> relative L2 distance [S] between the forward's and
    the teacher-forced decode's logits at each position."""
    full, _ = transformer.forward(params, tokens, model.cfg, rc)
    state = model.init_decode_state(1, tokens.shape[1], rc)
    dist = []
    for t in range(tokens.shape[1]):
        logits, state = model.decode_step(params, tokens[:, t:t + 1], state,
                                          rc)
        want = full[:, t]
        dist.append((logits[:, 0] - want).norm() / want.norm())
    return torch.stack(dist)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--w-rec-scale", type=float, default=1.0)
    ap.add_argument("--every", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).scaled(d_model=args.d_model,
                                       n_layers=args.layers,
                                       vocab_size=args.vocab)
    model = Model(cfg, device=args.device)
    params = model.init(args.seed, dtype=torch.float32)
    for p in params["layers"]:
        if "slstm" in p:
            p["slstm"]["w_rec"].mul_(args.w_rec_scale)
    rc = RunConfig(param_dtype="float32", activation_dtype="float32",
                   mlstm_chunk=args.chunk)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, cfg.vocab_size, (1, args.tokens),
                           generator=gen, dtype=torch.int32)
    dist = drift(model, params, tokens.to(model.device), rc).cpu()
    print(f"{cfg.name} d_model={cfg.d_model} layers={cfg.n_layers} chunk="
          f"{args.chunk} w_rec x{args.w_rec_scale} on {model.device}: "
          "relative L2, forward vs teacher-forced decode, by position")
    for t in range(0, args.tokens, args.every):
        print(f"  {t:5d} {float(dist[t]):.4e}")
    return dist


if __name__ == "__main__":
    main()
