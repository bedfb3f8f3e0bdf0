"""The kernels' tile knobs, the autotune loop and sharded candidate
scoring on the card.  Needs an NVIDIA GPU (``cuda`` marker); skips without
one.  Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_autotune_cuda.py

* gp_gram: every instantiation (tile, warps, ring depth) is bit-equal to
  the default launch, which holds the reference's atol 2e-4 against the
  plain version, at the reference's off-ladder shapes and the daemon's
  327 knobs (direct differences);
* flash: every instantiation of each route against the route's plain
  version at the reference's tolerances (2e-5 float32, 2e-2 bf16), and
  float32 tilings within 1e-5 of the default launch (the reference's
  block invariance);
* mlstm: every launch of each route against its plain version (5e-5
  float32; relative L2 1e-3 against the bf16-operand version on the
  wgmma route);
* a knob outside a route's set raises before anything launches;
* ``tune_kernel`` on the card returns a config the kernel takes;
* ``gp.select_batch_sharded`` over 1-3 shards of one card picks what
  ``gp.select_batch`` picks, at the tuner's and the daemon's shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import gp
from repro_torch.kernels import autotune
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gp_gram import ops as gram_ops
from repro_torch.kernels.gp_gram.ref import matern52
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunkwise


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, device, seed, scale=1.0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _rel(got, want):
    got, want = got.float(), want.float()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


# ---------------------------------------------------------------------------
# gp_gram: every tiling bit-equal to the default launch
# ---------------------------------------------------------------------------

GRAM_SHAPES = [(136, 136, 9), (136, 77, 9), (300, 77, 40), (333, 64, 327)]


@pytest.mark.cuda
@pytest.mark.parametrize("n, m, d", GRAM_SHAPES,
                         ids=lambda v: str(v))
def test_gp_gram_every_tiling_is_bit_equal(cuda, n, m, d):
    rng = np.random.default_rng(n + m + d)
    xa = torch.tensor(rng.random((n, d)), dtype=torch.float32, device=cuda)
    xb = torch.tensor(rng.random((m, d)), dtype=torch.float32, device=cuda)
    xb[:3] = xa[:3]                                   # r = 0 entries
    ls = torch.tensor(rng.uniform(0.1, 1.0, d), dtype=torch.float32,
                      device=cuda)
    base = gram_ops.matern52_cross(xa, xb, ls, 0.8)
    torch.testing.assert_close(base, matern52(xa, xb, ls, 0.8), atol=2e-4,
                               rtol=0)
    gbase = gram_ops.matern52_gram(xa, ls, 1.3)
    tiles = gram_ops.supported_tiles()
    for bn in tiles["block_n"]:
        for bm in tiles["block_m"]:
            for nw in tiles["num_warps"]:
                for st in tiles["pipeline"]:
                    kw = dict(block=bn, block_m=bm, num_warps=nw,
                              pipeline=st)
                    assert torch.equal(
                        gram_ops.matern52_cross(xa, xb, ls, 0.8, **kw),
                        base), kw
                    assert torch.equal(
                        gram_ops.matern52_gram(xa, ls, 1.3, **kw),
                        gbase), kw


@pytest.mark.cuda
def test_knobs_outside_the_set_raise_before_launching(cuda):
    x = torch.rand((40, 4), device=cuda)
    ls = torch.ones(4, device=cuda)
    before = gram_ops.gram_launches
    with pytest.raises(ValueError, match="block_n in"):
        gram_ops.matern52_gram(x, ls, 1.0, block=256)
    assert gram_ops.gram_launches == before
    q = torch.randn((1, 256, 2, 128), device=cuda).bfloat16()
    n = flash_ops.launches
    with pytest.raises(ValueError, match="no instantiation"):
        flash_ops.flash_attention(q, q, q, block_q=512, block_k=512)
    with pytest.raises(ValueError, match="num_warps=8"):
        flash_ops.flash_attention(q, q, q, num_warps=8)
    assert flash_ops.launches == n
    g = torch.randn((1, 256, 2), device=cuda)
    n = mlstm_ops.launches
    with pytest.raises(ValueError, match="pipeline=2"):
        mlstm_ops.mlstm_chunk(q.float(), q.float(), q.float(), g, -g.abs(),
                              pipeline=2)
    assert mlstm_ops.launches == n


# ---------------------------------------------------------------------------
# flash: every instantiation against the plain version
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (B, Sq, Sk, H, Kh, D, causal, window, softcap)
    (2, 256, 256, 4, 2, 64, True, None, None),
    (1, 200, 333, 8, 2, 128, False, 64, 20.0),
    (1, 512, 512, 2, 2, 128, True, None, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: str(c[:6]))
def test_flash_every_instantiation_matches_plain(cuda, case, dtype):
    B, Sq, Sk, H, Kh, D, causal, window, softcap = case
    q = _rand((B, Sq, H, D), cuda, 1, dtype=dtype)
    k = _rand((B, Sk, Kh, D), cuda, 2, dtype=dtype)
    v = _rand((B, Sk, Kh, D), cuda, 3, dtype=dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = flash_ops.plain_version(q, k, v, **kw).float()
    route = flash_ops.route(dtype, D)
    tiles = flash_ops.supported_tiles(route, dtype, D)
    assert len(tiles) > 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    base = flash_ops.flash_attention(q, k, v, **kw).float()
    n = flash_ops.launches
    for t in tiles:
        got = flash_ops.flash_attention(q, k, v, block_q=t[0],
                                        block_k=t[1], num_warps=t[2],
                                        pipeline=t[3], **kw).float()
        torch.testing.assert_close(got, want, atol=tol, rtol=0,
                                   msg=lambda m: f"{t}: {m}")
        if dtype == torch.float32:            # the reference's invariance
            torch.testing.assert_close(got, base, atol=1e-5, rtol=0)
    torch.cuda.synchronize()
    assert flash_ops.launches == n + len(tiles)


# ---------------------------------------------------------------------------
# mlstm: every launch against the plain version
# ---------------------------------------------------------------------------

def _mlstm_inputs(B, S, H, P, device, dtype):
    q = _rand((B, S, H, P), device, 4, 0.5, dtype)
    k = _rand((B, S, H, P), device, 5, 0.5 / P ** 0.5, dtype)
    v = _rand((B, S, H, P), device, 6, 0.5, dtype)
    logi = _rand((B, S, H), device, 7)
    logf = -torch.nn.functional.softplus(-_rand((B, S, H), device, 8) * 2)
    return q, k, v, logi, logf


@pytest.mark.cuda
@pytest.mark.parametrize("B, S, H, P, chunk", [
    (1, 256, 2, 32, 64), (2, 128, 2, 16, 32), (1, 512, 2, 64, 128)])
def test_mlstm_fma_every_launch_matches_plain(cuda, B, S, H, P, chunk):
    args = _mlstm_inputs(B, S, H, P, cuda, torch.float32)
    want = mlstm_chunkwise(*args, chunk)
    base = mlstm_ops.mlstm_chunk(*args, chunk=chunk)
    for nw, st in mlstm_ops.supported_tiles("fma", P, chunk):
        got = mlstm_ops.mlstm_chunk(*args, chunk=chunk, num_warps=nw,
                                    pipeline=st)
        torch.testing.assert_close(got, want, atol=5e-5, rtol=0)
        torch.testing.assert_close(got, base, atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("S, P, chunk", [
    (1024, 128, 128), (1024, 256, 256), (1024, 1024, 512), (2048, 64, 1024),
    (1024, 1024, 1024)])
def test_mlstm_wgmma_every_launch_matches_plain(cuda, S, P, chunk):
    args = _mlstm_inputs(1, S, 2, P, cuda, torch.bfloat16)
    assert mlstm_ops.route(torch.bfloat16, P, chunk) == "wgmma"
    want = mlstm_ops.plain_version(*args, chunk)
    n = mlstm_ops.launches_wgmma
    tiles = mlstm_ops.supported_tiles("wgmma", P, chunk)
    for nw, st in tiles:
        got = mlstm_ops.mlstm_chunk(*args, chunk=chunk, num_warps=nw,
                                    pipeline=st)
        assert _rel(got, want) < 1e-3, (nw, st)
    torch.cuda.synchronize()
    assert mlstm_ops.launches_wgmma == n + len(tiles)


# ---------------------------------------------------------------------------
# the tuner on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_tune_kernel_on_the_card(cuda):
    out = autotune.tune_kernel("gp_gram", budget=6, repeats=2, warmup=1,
                               fit_steps=10)
    best = out["best_config"]
    assert out["default_value"] is not None and out["best_value"] > 0
    assert out["best_value"] <= out["default_value"]
    gram_ops.resolve_tiles(best["block_n"], best["block_m"],
                           best["num_warps"], best["pipeline"])


# ---------------------------------------------------------------------------
# sharded selection on one card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d, n_cand, q", [(16, 2384, 8), (327, 3939, 8),
                                          (327, 3939, 1)])
def test_sharded_picks_equal_select_batch(cuda, d, n_cand, q):
    rng = np.random.default_rng(d + q)
    x = rng.random((56, d))
    y = np.sin(3 * x[:, 0]) + (x[:, 1] - 0.4) ** 2 + 0.1 * rng.normal(
        size=56)
    st = gp.fit(x, y, steps=40, pad_to=64, use_kernel=True, device=cuda)
    y_raw = np.zeros(64, np.float32)
    y_raw[:56] = y
    cand = rng.random((n_cand, d)).astype(np.float32)
    want = gp.select_batch(st, cand, y_raw, 56, float(y.min()), q,
                           use_kernel=True).cpu()
    for k in (1, 2, 3):
        before = gram_ops.cross_launches
        got = gp.select_batch_sharded(st, cand, y_raw, 56, float(y.min()),
                                      q, use_kernel=True,
                                      devices=(cuda,) * k).cpu()
        torch.cuda.synchronize()
        assert gram_ops.cross_launches == before + k
        assert torch.equal(got, want), (k, got, want)
