"""The hand-written CUDA chunkwise mLSTM kernels against their plain-torch
versions, on the card.  Needs an NVIDIA GPU (``cuda`` marker); skips
without one.  Imports nothing of JAX, so it runs on a machine that has
only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_mlstm_chunk_cuda.py

Tolerances: float32 at the reference's atol 5e-5 against both the
chunkwise plain version and the sequential oracle, and chunk invariance
within 2e-4 (``tests/test_kernels.py``).  A chunk wider than 512 (beyond
the reference's cases) is held at 1e-3: at chunk 2048 the float32 plain
version itself lands 2.6e-4 from a float64 evaluation of the same inputs
(measured on the host), so the two float32 versions can differ by more
than 5e-5 while both are right.  bfloat16 inputs go through both
versions as the same bf16 numbers, both compute in float32 and round h
once to bf16, so they differ where a rounding flips: one bf16 step at
|h| <= 2 is 7.8e-3, and the limit is atol 2e-2 + rtol 1e-2.  bf16 inputs
at the tensor-core route's shapes (``ops.route``) run the wgmma kernel,
which also rounds (q k^T) o W, k o wk and the stored state to bf16: it is
held to its own plain version (the same roundings) and to the float32
version at that same tolerance.  At the full-width layer shape the whole
output is held to a relative L2 error of 1e-3 against the route's plain
version and, on the wgmma route, of 1e-2 against the float32 version, the
limits ``chip_smoke.py`` uses (a planted fault lands far above both).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.mlstm_chunk import ops
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunkwise,
                                                 mlstm_sequential)

# (B, S, H, P, chunk): the reference's MLSTM_CASES, then the kernel's own
# edges: every compiled P, a chunk that is no multiple of the tiles, a
# chunk wider than one 256-row register tile, and chunk = S
CASES = [
    (2, 128, 2, 32, 32), (1, 256, 4, 64, 64), (2, 64, 1, 16, 16),
    (1, 512, 2, 32, 128), (1, 128, 2, 32, 128),
    (1, 96, 1, 16, 48), (1, 128, 1, 128, 64), (1, 64, 1, 256, 32),
    (1, 64, 1, 512, 64), (1, 64, 1, 1024, 32), (1, 1024, 1, 32, 512),
    (1, 2048, 1, 32, 2048),
]
# wgmma-route edges: P 64/128/1024, chunks 128/256/1024, S = chunk (one
# chunk, no state), odd B*H
WGMMA_CASES = [
    (1, 128, 1, 64, 128), (1, 512, 3, 64, 256), (3, 256, 1, 128, 128),
    (1, 512, 2, 128, 256), (1, 1024, 1, 1024, 1024), (1, 2048, 1, 1024, 1024),
    (1, 512, 1, 1024, 256), (1, 1024, 3, 256, 512),
]
FULL = (2, 4096, 4, 1024)            # xlstm-1.3b's mLSTM layer at B=2
TOL = {torch.float32: dict(atol=5e-5, rtol=0),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, S, H, P, device, dtype=torch.float32, seed=0):
    """The reference test's distributions: q, v ~ 0.5 N, k ~ 0.5 N /
    sqrt(P), logi ~ N, logf = -softplus(-2 N)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(                       # noqa: E731
        rng.standard_normal(s, dtype=np.float32))
    q, k, v = n(B, S, H, P) * 0.5, n(B, S, H, P) * 0.5 / P ** 0.5, \
        n(B, S, H, P) * 0.5
    logi = n(B, S, H)
    logf = -torch.nn.functional.softplus(-n(B, S, H) * 2.0)
    return ([t.to(device=device, dtype=dtype) for t in (q, k, v)]
            + [t.to(device) for t in (logi, logf)])


def _close(got, want, dtype, chunk=0):
    tol = dict(TOL[dtype])
    if dtype == torch.float32 and chunk > 512:
        tol["atol"] = 1e-3
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "B{}S{}H{}P{}C{}".format(*c))
def test_kernel_matches_plain_versions(cuda, case, dtype):
    B, S, H, P, chunk = case
    args = _inputs(B, S, H, P, cuda, dtype, seed=S * H + P)
    before = ops.launches
    out = ops.mlstm_chunk(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert out.shape == (B, S, H, P) and out.dtype == dtype
    assert bool(torch.isfinite(out.float()).all())
    _close(out, mlstm_chunkwise(*args, chunk), dtype, chunk)
    if S <= 512:
        _close(out, mlstm_sequential(*args), dtype, chunk)


@pytest.mark.cuda
def test_chunk_size_invariance(cuda):
    args = _inputs(1, 256, 2, 32, cuda, seed=11)
    outs = [ops.mlstm_chunk(*args, chunk=c) for c in (32, 64, 256)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=2e-4, rtol=0)


@pytest.mark.cuda
def test_strided_inputs_are_read_in_place(cuda):
    """q/k/v as head slices of one [B,S,3H,P] tensor and gates as columns
    of a wider one: the kernel reads them through their strides."""
    B, S, H, P = 1, 128, 2, 64
    q, k, v, li, lf = _inputs(B, S, H, P, cuda, seed=3)
    qkv = torch.cat([q, k, v], dim=2)
    gates = torch.cat([li, lf], dim=2)
    got = ops.mlstm_chunk(qkv[:, :, :H], qkv[:, :, H:2 * H],
                          qkv[:, :, 2 * H:], gates[..., :H], gates[..., H:],
                          chunk=32)
    want = ops.mlstm_chunk(q, k, v, li, lf, chunk=32)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


@pytest.mark.cuda
def test_full_width_layer_shape(cuda):
    args = _inputs(*FULL, cuda, torch.bfloat16, seed=5)
    for chunk, route in ((256, "wgmma"), (64, "fma")):
        assert ops.route(torch.bfloat16, FULL[3], chunk) == route
        out = ops.mlstm_chunk(*args, chunk=chunk)
        rel = _rel(out, ops.plain_version(*args, chunk))
        assert rel <= 1e-3, (chunk, rel)
        rel32 = _rel(out, mlstm_chunkwise(*args, chunk))
        assert rel32 <= 1e-2, (chunk, rel32)


@pytest.mark.cuda
@pytest.mark.parametrize("view", [False, True], ids=["dense", "strided"])
@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=lambda c: "B{}S{}H{}P{}C{}".format(*c))
def test_wgmma_route_edges_match_plain(cuda, case, view):
    B, S, H, P, chunk = case
    assert ops.route(torch.bfloat16, P, chunk) == "wgmma"
    args = _inputs(B, S, H, P, cuda, torch.bfloat16, seed=S + H + P)
    if view:     # head slices of one [B,S,3H,P] tensor, gate columns
        qkv = torch.cat(args[:3], dim=2)
        gates = torch.cat(args[3:], dim=2)
        args = [qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:],
                gates[..., :H], gates[..., H:]]
    before = (ops.launches, ops.launches_wgmma, ops.launches_fma)
    out = ops.mlstm_chunk(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert (ops.launches, ops.launches_wgmma, ops.launches_fma) == (
        before[0] + 1, before[1] + 1, before[2])
    assert out.shape == (B, S, H, P) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    _close(out, ops.plain_version(*args, chunk), torch.bfloat16)
    _close(out, mlstm_chunkwise(*args, chunk), torch.bfloat16)


@pytest.mark.cuda
def test_wgmma_route_rejects_views_tma_cannot_read(cuda):
    q, k, v, li, lf = _inputs(1, 256, 1, 64, cuda, torch.bfloat16)
    wide = torch.zeros((1, 256, 1, 72), dtype=torch.bfloat16, device=cuda)
    wide[..., 1:65] = q
    with pytest.raises(ValueError, match="TMA"):
        ops.mlstm_chunk(wide[..., 1:65], k, v, li, lf, chunk=128)


@pytest.mark.cuda
def test_wrapper_errors(cuda):
    q, k, v, li, lf = _inputs(1, 64, 1, 32, cuda)
    with pytest.raises(ValueError, match="head width"):
        ops.mlstm_chunk(*_inputs(1, 64, 1, 48, cuda), chunk=16)
    with pytest.raises(ValueError, match="divide"):
        ops.mlstm_chunk(*_inputs(1, 100, 1, 32, cuda), chunk=64)
    with pytest.raises(TypeError, match="q is"):
        ops.mlstm_chunk(q, k.bfloat16(), v, li, lf)
    with pytest.raises(TypeError, match="float32"):
        ops.mlstm_chunk(q, k, v, li.bfloat16(), lf)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.mlstm_chunk(q.half(), k.half(), v.half(), li, lf)
    with pytest.raises(ValueError, match="is on"):
        ops.mlstm_chunk(q, k.cpu(), v, li, lf)
    with pytest.raises(ValueError, match="unit stride"):
        ops.mlstm_chunk(q.transpose(2, 3), k.transpose(2, 3),
                        v.transpose(2, 3), li, lf)


def _in_fresh_thread(fn):
    """fn() on a new thread that has made no CUDA call; its exception, if
    any, raised here."""
    import threading
    box = {}

    def work():
        try:
            box["out"] = fn()
            torch.cuda.synchronize()
        except Exception as e:                   # re-raised below
            box["err"] = e
    worker = threading.Thread(target=work)
    worker.start()
    worker.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.mark.cuda
def test_wgmma_launch_from_a_fresh_thread(cuda):
    # a worker thread whose memory comes from PyTorch's cache makes no
    # CUDA call before the launcher encodes its tensor maps: the launcher
    # binds the device's context itself
    args = _inputs(1, 512, 2, 256, cuda, torch.bfloat16, seed=3)
    assert ops.route(torch.bfloat16, 256, 256) == "wgmma"
    want = ops.mlstm_chunk(*args, chunk=256)
    ops.mlstm_chunk(*args, chunk=256)            # freed into the cache
    torch.cuda.synchronize()
    got = _in_fresh_thread(lambda: ops.mlstm_chunk(*args, chunk=256))
    assert torch.equal(got, want)
