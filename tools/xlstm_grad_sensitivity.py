#!/usr/bin/env python3
"""How far does xlstm-1.3b's step-1 gradient move when its mLSTM forward
is perturbed at the level of its own rounding?

    python3 tools/xlstm_grad_sensitivity.py      # from the root of a checkout, one GPU

The cell is ``chip_smoke.py``'s xlstm training cell (full width, one
period of the pattern: 7 mLSTM and 1 sLSTM layer, the sLSTM's recurrent
weights x0.1, global batch 2 x 4096, microbatch 1, remat ``block``).  For
each row it computes step 1's loss and gradients (accumulated over the
microbatches as the train step does) twice and prints the worst leaf's
relative L2 distance and the median over the leaves:

* ``bf16 kernels / plain``: the mLSTM kernels (wgmma forward, backward
  with its roundings) against ``ref.mlstm_chunkwise`` through autograd
  (float32, no rounding);
* ``bf16 plain rounded / plain``: no kernel at all, the plain version
  with the wgmma route's roundings and the stabilisers detached against
  the unrounded one;
* ``bf16 kernels / plain rounded``: the kernels against their own plain
  version;
* ``bf16, no sLSTM``: the first row on the 7 mLSTM layers alone;
* ``float32 kernels / plain``: float32 weights and activations (the FMA
  forward, the backward without roundings).

Prints the card's name and power limit first; exits non-zero without a
GPU.  Imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels.mlstm_chunk import ops, ref
    from repro_torch.models import xlstm
    from repro_torch.models.common import tree_flatten_with_path
    from repro_torch.train.data import batch_at
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for which in ("wgmma", "fma", "bwd"):
        ops.build(which=which)
    ops.load()

    def grads(model, params, batch, rc, mlstm=None):
        saved = xlstm.mlstm_ops
        if mlstm is not None:
            xlstm.mlstm_ops = SimpleNamespace(mlstm_chunk=mlstm)
        try:
            loss, g = cs.micro_grads(model, params, batch, rc,
                                     cs.TRAIN_B // cs.TRAIN_MICRO)
        finally:
            xlstm.mlstm_ops = saved
        return loss, {p: x for p, x in tree_flatten_with_path(g)[0]}

    def plain(**kw):
        def f(q, k, v, logi, logf, *, chunk):
            return ref.mlstm_chunkwise(q, k, v, logi, logf,
                                       min(chunk, q.shape[1]), **kw)
        return f

    def report(label, a, b):
        rels = sorted(((cs.rel_l2(a[1][p], b[1][p]),
                        "/" + "/".join(map(str, p))) for p in b[1]),
                      reverse=True)
        print(f"{label}: loss rel {abs(a[0] - b[0]) / abs(b[0]):.3e}; "
              f"worst leaf {rels[0][0]:.3e} at {rels[0][1]}; median "
              f"{rels[len(rels) // 2][0]:.3e} over {len(rels)} leaves",
              flush=True)

    rounded = plain(operand_dtype=torch.bfloat16, detach_m=True)
    for dtype, layers in (("bfloat16", 8), ("bfloat16", 7), ("float32", 8)):
        t0 = time.perf_counter()
        model, params, rc, _ = cs.xlstm_train_model(dtype, layers)
        batch = batch_at(cs.TRAIN_SEED, 0, global_batch=cs.TRAIN_B,
                         seq_len=cs.TRAIN_S, vocab_size=model.cfg.vocab_size,
                         device="cuda")
        kern = grads(model, params, batch, rc)
        ref_g = grads(model, params, batch, rc, plain())
        if dtype == "float32":
            report("float32 kernels / plain", kern, ref_g)
        elif layers == 7:
            report("bf16, no sLSTM: kernels / plain", kern, ref_g)
        else:
            rnd = grads(model, params, batch, rc, rounded)
            report("bf16 kernels / plain", kern, ref_g)
            report("bf16 plain rounded / plain", rnd, ref_g)
            report("bf16 kernels / plain rounded", kern, rnd)
            del rnd
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
        del kern, ref_g, params, model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
