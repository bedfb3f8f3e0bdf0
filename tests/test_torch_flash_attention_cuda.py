"""The hand-written CUDA flash-attention kernels against their plain-torch
versions, on the card.  Needs an NVIDIA GPU (``cuda`` marker); skips
without one.  Imports nothing of JAX, so it runs on a machine that has
only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_flash_attention_cuda.py

Two routes (``ops.route``): bf16 at head dims 64 and 128 runs the wgmma
kernel, held against the plain version that rounds P to bf16 before P.V
(``p_dtype=torch.bfloat16``); float32, and bf16 at the other head dims,
runs the FMA kernel, held against the float32-P plain version.
Tolerances are the reference's flash tolerances (``tests/test_kernels.py``):
atol 2e-5 in float32, 2e-2 in bfloat16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import reference_attention

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])

# (B, Sq, Sk, H, Kh, D, causal, window, softcap): the reference's
# FLASH_CASES, then cases for the kernels' own edges: every compiled head
# dim, ragged tiles, Sq != Sk, a window without causal, and yi-6b's heads
# at a short prefill
CASES = [
    (2, 256, 256, 4, 2, 64, True, None, None),
    (1, 128, 384, 8, 8, 128, True, None, 30.0),
    (2, 200, 200, 4, 1, 64, True, 64, None),
    (1, 512, 512, 2, 2, 128, False, None, None),
    (1, 96, 96, 6, 6, 64, True, None, None),
    (2, 64, 64, 4, 4, 32, True, 16, 10.0),
    (1, 77, 77, 4, 2, 16, True, None, None),
    (1, 130, 70, 2, 1, 256, True, None, None),
    (1, 100, 300, 2, 2, 64, False, 8, None),
    (1, 70, 200, 2, 1, 32, False, None, 5.0),
    (1, 1000, 1000, 32, 4, 128, True, None, None),
]

# the wgmma route's own edges (bf16, D 64 and 128): Sq and Sk off the
# 64-row and 128-key tiles and unequal, GQA ratios 1, 4 and 8, window and
# soft-cap, with and without causal
WGMMA_CASES = [
    (1, 65, 65, 2, 2, 128, True, None, None),
    (1, 191, 129, 4, 1, 64, True, None, None),
    (2, 129, 333, 8, 2, 128, False, None, None),
    (1, 333, 129, 8, 1, 128, True, None, None),
    (1, 300, 300, 8, 8, 64, True, 100, None),
    (1, 257, 257, 16, 2, 128, True, 130, 20.0),
    (1, 200, 450, 4, 1, 64, False, 50, 10.0),
    (2, 127, 127, 4, 1, 128, True, None, 50.0),
    (1, 1, 1, 4, 4, 128, True, None, None),
    (1, 17, 300, 8, 1, 64, False, None, None),
]


# the MoE and whisper paths' shapes (bf16, the wgmma route), as
# ``chip_smoke.py`` phase 12 drives them: whisper's encoder
# self-attention (Sk 1500 = 11 key tiles of 128 and a ragged 92, without
# the causal mask), its cross-attention (Sq 448, Sk 1500) and
# qwen2-moe's MHA prefill.  Held like phase 5's path shapes: atol 2e-2
# and relative L2 1e-2 of the whole output, against both plain versions
PATH_CASES = [
    (2, 1500, 1500, 6, 6, 64, False),
    (2, 448, 1500, 6, 6, 64, False),
    (2, 4096, 4096, 16, 16, 128, True),
]
PATH_REL_L2 = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(case, dtype, device, seed):
    B, Sq, Sk, H, Kh, D = case[:6]
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, Sq, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, Kh, D), dtype=np.float32),
            rng.standard_normal((B, Sk, Kh, D), dtype=np.float32))
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in arrs]


def _counts():
    return ops.launches, ops.launches_wgmma, ops.launches_fma


def _check_against_plain(q, k, v, **kw):
    route = ops.route(q.dtype, q.shape[3])
    n, n_wgmma, n_fma = _counts()
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.plain_version(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _counts() == (n + 1, n_wgmma + (route == "wgmma"),
                         n_fma + (route == "fma"))
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[q.dtype], rtol=0)
    return got


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}S{}x{}H{}-{}D{}"
                         .format(*c[:6]))
def test_kernel_matches_plain(case, dtype, cuda):
    causal, window, softcap = case[6:]
    q, k, v = _qkv(case, dtype, cuda, seed=case[1] + case[3])
    _check_against_plain(q, k, v, causal=causal, window=window,
                         softcap=softcap)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=lambda c: "B{}S{}x{}H{}-{}D{}c{}w{}s{}"
                         .format(*c))
def test_wgmma_route_edges_match_plain(case, cuda):
    causal, window, softcap = case[6:]
    q, k, v = _qkv(case, torch.bfloat16, cuda, seed=case[1] * 7 + case[2])
    assert ops.route(q.dtype, q.shape[3]) == "wgmma"
    got = _check_against_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    # the Pallas kernel's function keeps P in f32: the kernel is held to
    # the reference's bf16 tolerance against that too
    want = reference_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PATH_CASES,
                         ids=lambda c: "B{}S{}x{}H{}-{}D{}c{}".format(*c))
def test_moe_and_whisper_path_shapes_match_plain(case, cuda):
    causal = case[6]
    q, k, v = _qkv(case, torch.bfloat16, cuda, seed=case[1] + case[2])
    assert ops.route(q.dtype, q.shape[3]) == "wgmma"
    got = _check_against_plain(q, k, v, causal=causal).float()
    for p_dtype in (torch.bfloat16, None):
        want = reference_attention(q, k, v, causal=causal,
                                   p_dtype=p_dtype).float()
        rel = float((got - want).norm() / want.norm())
        assert rel <= PATH_REL_L2, (p_dtype, rel)
    # the last key tile's 92 keys count: without them the rows change
    # by far more than the limit
    if not causal and case[2] % 128:
        cut = case[2] - case[2] % 128
        short = reference_attention(q, k[:, :cut], v[:, :cut], causal=False,
                                    p_dtype=torch.bfloat16).float()
        assert float((short - got).norm() / got.norm()) > PATH_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_kernel_matches_plain(D, cuda):
    """Several 128-row q blocks, each with two warpgroups of 64 rows, on
    ragged edges, against both plain versions."""
    case = (2, 333, 333, 8, 2, D)
    q, k, v = _qkv(case, torch.bfloat16, cuda, seed=D)
    got = ops._wgmma(q, k, v, True, None, None)
    torch.cuda.synchronize()
    for p_dtype in (torch.bfloat16, None):
        want = reference_attention(q, k, v, p_dtype=p_dtype)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=0)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("D", [64, 128])
def test_rows_with_nothing_visible_are_zero(D, dtype, cuda):
    """A window without causal leaves rows i >= Sk + window - 1 with no
    key; the kernels write zeros there (as the TPU kernel does), and the
    visible rows match the plain version."""
    q, k, v = _qkv((1, 300, 100, 2, 2, D), dtype, cuda, seed=3)
    got = ops.flash_attention(q, k, v, causal=False, window=8)
    want = ops.plain_version(q, k, v, causal=False, window=8)
    torch.cuda.synchronize()
    assert bool((got[:, 107:] == 0).all())
    torch.testing.assert_close(got[:, :107].float(), want[:, :107].float(),
                               atol=TOL[dtype], rtol=0)
    empty = ops.flash_attention(q, k[:, :0], v[:, :0])    # no key at all
    torch.cuda.synchronize()
    assert empty.shape == q.shape and bool((empty == 0).all())


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("D", [64, 128])
def test_strided_inputs_read_in_place(D, dtype, cuda):
    """Views with non-default strides (heads sliced out of a wider tensor,
    and a transposed [B, H, S, D] tensor seen as [B, S, H, D]) give the
    same result as their contiguous copies."""
    wide = torch.randn((2, 200, 8, D), device=cuda).to(dtype)
    q = wide[:, :, :4]
    k, v = wide[:, :, 4:6], wide[:, :, 6:8]
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    bhsd = torch.randn((2, 4, 200, D), device=cuda).to(dtype)
    q = bhsd.transpose(1, 2)
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.contiguous(), k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(got.float(), ops.plain_version(q, k, v).float(),
                               atol=TOL[dtype], rtol=0)


# tile pairs each route has at its default num_warps and pipeline: the
# reference's (64, 64), (128, 256), (256, 128) are not all instantiated on
# the card, so the pairs moved into the routes' sets
BLOCK_PAIRS = {torch.float32: [(64, 64), (32, 64), (128, 32)],
               torch.bfloat16: [(128, 128), (64, 64), (64, 128), (128, 64)]}


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("D", [64, 128])
def test_block_size_knobs_do_not_change_the_output(D, dtype, cuda):
    """Float32 within the reference's 1e-5 across tiles; bf16 (the wgmma
    kernel rescales P at each tile's running max, so a tiling moves its
    bf16 roundings) each within the route's tolerance of its plain
    version and of the other tiles."""
    q, k, v = _qkv((1, 256, 256, 4, 2, D), dtype, cuda, seed=7)
    outs = [ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
            for bq, bk in BLOCK_PAIRS[dtype]]
    want = ops.plain_version(q, k, v).float()
    tol = 1e-5 if dtype == torch.float32 else TOL[dtype]
    for o in outs:
        torch.testing.assert_close(o.float(), want, atol=TOL[dtype], rtol=0)
        torch.testing.assert_close(o.float(), outs[0].float(), atol=tol,
                                   rtol=0)


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.randn((1, 8, 4, 64), device=cuda)
    with pytest.raises(ValueError):          # mixed devices
        ops.flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(TypeError):           # float16 is not compiled
        h = q.half()
        ops.flash_attention(h, h, h)
    with pytest.raises(ValueError):          # head_dim 48 is not compiled
        x = torch.randn((1, 8, 4, 48), device=cuda)
        ops.flash_attention(x, x, x)
    # the wgmma route does not fall back to the FMA kernel on a view TMA
    # cannot read (a base pointer 8 bytes past a 16-byte boundary)
    buf = torch.randn(8 * 4 * 128 + 4, device=cuda).bfloat16()
    x = buf[4:].view(1, 8, 4, 128)
    before = _counts()
    with pytest.raises(ValueError, match="TMA"):
        ops.flash_attention(x, x, x)
    assert _counts() == before


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
    # a tuner's worker thread whose output memory comes from PyTorch's
    # cache makes no CUDA call before the launcher encodes its tensor maps:
    # the launcher binds the device's context itself
    q, k, v = _qkv((2, 512, 512, 8, 2, 128), torch.bfloat16, cuda, seed=3)
    assert ops.route(q.dtype, 128) == "wgmma"
    want = ops.flash_attention(q, k, v)
    ops.flash_attention(q, k, v)                 # freed into the cache
    torch.cuda.synchronize()
    got = _in_fresh_thread(lambda: ops.flash_attention(q, k, v))
    assert torch.equal(got, want)
