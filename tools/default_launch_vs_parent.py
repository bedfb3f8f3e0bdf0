#!/usr/bin/env python3
"""The default launches of the Gram forward, of both flash-attention
forwards and of the mLSTM tensor-core kernel against an earlier version of
their sources, on the card: the same bits, and the device time of each in
turns (old, new, new, old).  The serving launches (the flash forwards
with a null log-sum-exp pointer) must stay as they were.

    git archive <commit> src/repro_torch/kernels | tar -x -C build/parent
    python3 tools/default_launch_vs_parent.py build/parent

The earlier sources (``<dir>/src/repro_torch/kernels/gp_gram/csrc/
gp_gram.cu``, ``.../flash_attention/csrc/flash_attention_wgmma.cu`` and
``flash_attention.cu``, ``.../mlstm_chunk/csrc/mlstm_chunk_wgmma.cu``)
must export this tree's interfaces: the tile knobs and the flash
forwards' log-sum-exp pointer, which the serving launches leave null
(the tree of commit 1130823 on); each is built as its own library under
``build/``, all at once.  Shapes: the Gram forward at the
tuner's [64, 16] and [2384, 16] x [64, 16] and the daemon's [64, 327] and
[3939, 327] x [64, 327]; the Gram's backward at the fit's [64, 16] (the
same bits) and the daemon's [64, 327] (timed only: its bits may differ
from an earlier tree's, so the relative L2 between the two is printed);
flash at yi-6b's bf16 prefill (B 2, S 4096, H
32, Kh 4, D 128, causal) on the wgmma route and in float32 on the FMA
route (B 1, S 2048, same heads); mLSTM at xlstm-1.3b's bf16 layer (B 2,
S 4096, H 4, P 1024, chunk 256).  Device time per call from
``torch.profiler`` (200 calls of the Gram, 20 of the others; an mLSTM
call is its four passes).  Prints the card's name and power limit first;
exits non-zero without a GPU or when the bits differ where they must
not.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GRAM_SHAPES = ((64, 64, 16), (2384, 64, 16), (64, 64, 327),
               (3939, 64, 327))
# the backward's shapes (n, d), and whether its bits must equal the
# earlier tree's
GRAM_BWD_SHAPES = (((64, 16), True), ((64, 327), False))
FLASH_SHAPE = (2, 4096, 32, 4, 128)      # B, S, H, Kh, D
FLASH_FMA_SHAPE = (1, 2048, 32, 4, 128)  # float32, the FMA route
MLSTM_SHAPE = (2, 4096, 4, 1024, 256)    # B, S, H, P, chunk


def _turns(label, launch, outs, calls, exact=True):
    """Device µs per launch of launch["old"] / ["new"] in turns, and
    whether their outputs are bit-equal (``exact``; else the relative L2
    between them is printed and the check passes)."""
    import torch
    import chip_smoke
    launch["old"]()
    launch["new"]()
    torch.cuda.synchronize()
    same = torch.equal(outs["old"], outs["new"])
    us = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        us[name].append(chip_smoke.device_ms(launch[name], calls=calls)
                        * 1e3)
    rel = chip_smoke.rel_l2(outs["new"], outs["old"])
    print(f"{label} default launch, device us per launch: earlier "
          f"{us['old']}, this tree {us['new']}; bit-equal {same}"
          + ("" if exact else f", relative L2 {rel:.3e} (timed only)"),
          flush=True)
    return same or not exact


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    parent = Path(sys.argv[1]) / "src" / "repro_torch" / "kernels"
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from repro_torch.kernels.build import NvccLibrary
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gp_gram import ops as gram_ops
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
    from repro_torch.kernels.tma import tma_strides

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    old_gram = NvccLibrary(
        "gp_gram_parent", parent / "gp_gram" / "csrc" / "gp_gram.cu",
        gram_ops._LIB.functions)
    old_flash = NvccLibrary(
        "flash_attention_parent",
        parent / "flash_attention" / "csrc" / "flash_attention_wgmma.cu",
        flash_ops._LIBS["wgmma"].functions)
    old_fma = NvccLibrary(
        "flash_attention_fma_parent",
        parent / "flash_attention" / "csrc" / "flash_attention.cu",
        flash_ops._LIBS["fma"].functions)
    old_mlstm = NvccLibrary(
        "mlstm_chunk_parent",
        parent / "mlstm_chunk" / "csrc" / "mlstm_chunk_wgmma.cu",
        mlstm_ops._LIBS["wgmma"].functions)
    pairs = [(old_gram, gram_ops._LIB),
             (old_flash, flash_ops._LIBS["wgmma"]),
             (old_fma, flash_ops._LIBS["fma"]),
             (old_mlstm, mlstm_ops._LIBS["wgmma"])]
    with ThreadPoolExecutor(2 * len(pairs)) as pool:
        list(pool.map(lambda lib: lib.build(),
                      [lib for pair in pairs for lib in pair]))
    (old_g, new_g), (old_f, new_f), (old_a, new_a), (old_m, new_m) = (
        (old.load(), new.load()) for old, new in pairs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for n, m, d in GRAM_SHAPES:
        xa = torch.rand((n, d), generator=gen, device="cuda")
        xb = torch.rand((m, d), generator=gen, device="cuda")
        ls = torch.full((d,), 0.3, device="cuda")
        sv = torch.ones(1, device="cuda")
        outs = {key: torch.empty((n, m), device="cuda")
                for key in ("old", "new")}
        args = [xa.data_ptr(), xb.data_ptr(), ls.data_ptr(), sv.data_ptr()]
        ok &= _turns(f"gp_gram [{n},{d}]x[{m},{d}]", {
            key: (lambda lib, key: lambda: lib.matern52_launch(
                *args, outs[key].data_ptr(), n, m, d,
                *gram_ops.DEFAULT_TILES, stream))(lib, key)
            for key, lib in (("old", old_g), ("new", new_g))}, outs, 200)

    for (n, d), exact in GRAM_BWD_SHAPES:
        x = torch.rand((n, d), generator=gen, device="cuda")
        x[-8:] = 0.5                      # the fit's pad rows
        ls = 0.1 + 0.9 * torch.rand((d,), generator=gen, device="cuda")
        sv = torch.full((1,), 1.7, device="cuda")
        g = torch.randn((n, n), generator=gen, device="cuda")
        # scratch for either tree's launch (an earlier tree: ceil(n / 64)
        # rows when n > 64)
        rows = max(1, -(-n // 64), gram_ops.bwd_grid(n, d)[1])
        partial = torch.empty((rows, d + 1), device="cuda")
        outs = {key: torch.empty((d + 1,), device="cuda")
                for key in ("old", "new")}
        args = [x.data_ptr(), ls.data_ptr(), sv.data_ptr(), g.data_ptr(),
                partial.data_ptr()]
        ok &= _turns(f"gp_gram backward [{n},{d}]", {
            key: (lambda lib, key: lambda: lib.matern52_gram_bwd_launch(
                *args, outs[key].data_ptr(), n, d, stream))(lib, key)
            for key, lib in (("old", old_g), ("new", new_g))}, outs, 200,
            exact=exact)

    B, S, H, Kh, D = FLASH_SHAPE
    q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
               for s in ((B, S, H, D), (B, S, Kh, D), (B, S, Kh, D)))
    outs = {key: torch.empty_like(q) for key in ("old", "new")}
    strides = (ctypes.c_longlong * 12)(
        *tma_strides(q), *tma_strides(k), *tma_strides(v),
        *outs["old"].stride()[:3])
    common = (B, H, Kh, S, S, D, strides, 1, 0, 0.0, 1.0 / math.sqrt(D))
    bq, bk, _, stages = flash_ops.DEFAULT_TILES["wgmma"]
    ok &= _turns(f"flash wgmma [{B},{S},{H},{D}] Kh {Kh}", {
        "old": lambda: old_f.flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), outs["old"].data_ptr(),
            *common, bq, bk, stages, None, stream),
        "new": lambda: new_f.flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), outs["new"].data_ptr(),
            *common, bq, bk, stages, None, stream)}, outs, 20)

    B, S, H, Kh, D = FLASH_FMA_SHAPE
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               for s in ((B, S, H, D), (B, S, Kh, D), (B, S, Kh, D)))
    outs = {key: torch.empty_like(q) for key in ("old", "new")}
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *outs["old"].stride()[:3])
    common = (0, B, H, Kh, S, S, D, strides, 1, 0, 0.0, 1.0 / math.sqrt(D),
              *flash_ops.DEFAULT_TILES["fma"][:3])
    ok &= _turns(f"flash fma float32 [{B},{S},{H},{D}] Kh {Kh}", {
        "old": lambda: old_a.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), outs["old"].data_ptr(),
            *common, None, stream),
        "new": lambda: new_a.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), outs["new"].data_ptr(),
            *common, None, stream)}, outs, 20)

    B, S, H, P, c = MLSTM_SHAPE
    q, k, v = (torch.randn((B, S, H, P), generator=gen, device="cuda")
               .mul(0.5 / (P ** 0.5 if i == 1 else 1)).bfloat16()
               for i in range(3))
    logi = torch.randn((B, S, H), generator=gen, device="cuda")
    logf = -torch.nn.functional.softplus(
        -2 * torch.randn((B, S, H), generator=gen, device="cuda"))
    outs = {key: torch.empty_like(q) for key in ("old", "new")}
    n, bh = S // c, B * H
    scratch = {key: [torch.empty(s, device="cuda") for s in
                     ((bh, 5, S), (bh, 3, n), (bh, n - 1, P))]
               + [torch.empty((bh, n - 1, P, P), device="cuda",
                              dtype=torch.bfloat16)]
               for key in ("old", "new")}
    strides = (ctypes.c_longlong * 18)(
        *tma_strides(q), *tma_strides(k), *tma_strides(v),
        *logi.stride(), *logf.stride(), *outs["old"].stride()[:3])
    nw, st = mlstm_ops.default_tiles("wgmma", c)

    def mlstm(lib, key, *knobs):
        return lambda: lib.mlstm_chunk_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
            logf.data_ptr(), outs[key].data_ptr(),
            *(t.data_ptr() for t in scratch[key]), B, S, H, P, c, strides,
            *knobs, stream)
    ok &= _turns(f"mlstm wgmma [{B},{S},{H},{P}] chunk {c}", {
        "old": mlstm(old_m, "old", st, nw // 4),
        "new": mlstm(new_m, "new", st, nw // 4)}, outs, 20)
    if not ok:
        sys.exit("a default launch's bits moved")


if __name__ == "__main__":
    main()
