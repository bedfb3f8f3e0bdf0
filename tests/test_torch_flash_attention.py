"""The port's ``flash_attention`` wrapper against the JAX reference.

On CPU tensors the wrapper computes its plain-torch version; that path is
held against the reference's jnp oracle over every ``FLASH_CASES`` entry
in float32 and bfloat16 at the reference's own tolerances (2e-5 / 2e-2,
``tests/test_kernels.py``), and against the Pallas kernel in interpret
mode on two cases.  The plain version of the bf16 (wgmma) route, which
rounds P to bf16 before P.V (``p_dtype=torch.bfloat16``), is held against
the same oracle and the Pallas kernel at the bf16 tolerance.  The route
choice and the TMA alignment check are pure functions of the inputs and
are tested here; the CUDA kernels themselves are held against the plain
versions on the card by ``test_torch_flash_attention_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import reference_attention as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import reference_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the reference's FLASH_CASES (tests/test_kernels.py):
# (B, Sq, Sk, H, Kh, D, causal, window, softcap, bq, bk)
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, None, 128, 128),
    (1, 128, 384, 8, 8, 128, True, None, 30.0, 128, 128),
    (2, 200, 200, 4, 1, 64, True, 64, None, 128, 128),
    (1, 512, 512, 2, 2, 128, False, None, None, 256, 128),
    (1, 96, 96, 6, 6, 64, True, None, None, 128, 128),
    (2, 64, 64, 4, 4, 32, True, 16, 10.0, 64, 64),
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, dtype, seed):
    """The same numbers for both packages: drawn in float32 with numpy,
    rounded once to ``dtype`` by JAX and handed to torch bit for bit."""
    B, Sq, Sk, H, Kh, D = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Sq, H, D), (B, Sk, Kh, D), (B, Sk, Kh, D))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32)))
          .to(TORCH_DT[dtype]) for a in jx]
    return jx, tx


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "B{}S{}x{}H{}-{}D{}"
                         .format(*c[:6]))
def test_cpu_path_matches_reference(case, dtype):
    causal, window, softcap, bq, bk = case[6:]
    (jq, jk, jv), (q, k, v) = _inputs(case, dtype, seed=case[1] + case[3])
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, block_q=bq, block_k=bk)
    want = jax_ref(jq, jk, jv, causal=causal, window=window, softcap=softcap)
    assert got.dtype == TORCH_DT[dtype] and got.shape == q.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL[dtype])


@pytest.mark.parametrize("case", [FLASH_CASES[2], FLASH_CASES[5]],
                         ids=["window64", "window16-softcap"])
def test_cpu_path_matches_pallas_interpret(case):
    causal, window, softcap, bq, bk = case[6:]
    (jq, jk, jv), (q, k, v) = _inputs(case, "float32", seed=11)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    want = jax_flash(jq, jk, jv, causal=causal, window=window,
                     softcap=softcap, block_q=bq, block_k=bk)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


def test_block_size_invariance():
    """The tile knobs do not change the output (reference: within 1e-5)."""
    _, (q, k, v) = _inputs((1, 256, 256, 4, 2, 64), "float32", seed=7)
    outs = [ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
            for bq, bk in [(64, 64), (128, 256), (256, 128)]]
    for o in outs[1:]:
        np.testing.assert_allclose(_np(outs[0]), _np(o), atol=1e-5)


def _counts():
    return ops.launches, ops.launches_wgmma, ops.launches_fma


def test_cpu_path_launches_nothing():
    _, (q, k, v) = _inputs((1, 16, 16, 2, 1, 32), "float32", seed=1)
    before = _counts()
    ops.flash_attention(q, k, v)
    assert _counts() == before


@pytest.mark.parametrize("dtype, D", [("bfloat16", 128), ("bfloat16", 64),
                                      ("float32", 128), ("bfloat16", 32)])
def test_cpu_calls_count_no_launch_on_either_route(dtype, D):
    """A CPU call launches nothing and returns the plain version of the
    route's kernel: P rounded to bf16 on the wgmma route only."""
    _, (q, k, v) = _inputs((1, 40, 40, 4, 2, D), dtype, seed=2)
    before = _counts()
    out = ops.flash_attention(q, k, v)
    assert _counts() == before
    wgmma = ops.route(q.dtype, D) == "wgmma"
    want = reference_attention(q, k, v,
                               p_dtype=torch.bfloat16 if wgmma else None)
    assert out.dtype == TORCH_DT[dtype] and torch.equal(out, want)


@pytest.mark.parametrize("dtype, D, want", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.float32, 128, "fma"), (torch.float32, 64, "fma"),
    (torch.bfloat16, 16, "fma"), (torch.bfloat16, 32, "fma"),
    (torch.bfloat16, 256, "fma"), (torch.float32, 256, "fma"),
])
def test_route_from_dtype_and_head_dim(dtype, D, want):
    assert ops.route(dtype, D) == want


def _view(shape, strides, offset=0):
    """A bf16 [B, S, heads, D] view of a CPU buffer with element strides
    ``strides`` (D contiguous), starting ``offset`` elements in."""
    size = offset + 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    buf = torch.zeros(size + 64, dtype=torch.bfloat16)
    buf = buf[(-buf.data_ptr() // 2) % 8:]    # from a 16-byte boundary
    return buf.as_strided(shape, strides, buf.storage_offset() + offset)


@pytest.mark.parametrize("bad", ["base", "stride_s", "stride_h", "stride_b"])
def test_tma_check_rejects_misaligned_views(bad):
    shape, strides, offset = (2, 8, 4, 64), [8 * 4 * 64, 4 * 64, 64, 1], 0
    if bad == "base":
        offset = 4                           # 8 bytes past a boundary
    else:
        strides[{"stride_b": 0, "stride_s": 1, "stride_h": 2}[bad]] += 4
    x = _view(shape, strides, offset)
    ok = _view(shape, [8 * 4 * 64, 4 * 64, 64, 1])
    before = _counts()
    with pytest.raises(ValueError, match="TMA"):
        ops.check_tma(ok, x, ok)
    assert _counts() == before


def test_tma_check_accepts_aligned_views():
    """Views the model path makes (heads sliced out of a wider tensor)
    and any stride of a dim of one element pass."""
    wide = _view((2, 8, 12, 128), [8 * 12 * 128, 12 * 128, 128, 1])
    ops.check_tma(wide[:, :, :8], wide[:, :, 8:10], wide[:, :, 10:12])
    ops.check_tma(_view((1, 8, 1, 64), [3, 64, 5, 1]))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "B{}S{}x{}H{}-{}D{}"
                         .format(*c[:6]))
def test_bf16_p_rounding_matches_reference(case):
    """The plain version of the bf16 route (P rounded to bf16 before P.V)
    stays within the reference's bf16 tolerance of its oracle."""
    causal, window, softcap = case[6:9]
    (jq, jk, jv), (q, k, v) = _inputs(case, "bfloat16", seed=case[1] + case[3])
    got = reference_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, p_dtype=torch.bfloat16)
    want = jax_ref(jq, jk, jv, causal=causal, window=window, softcap=softcap)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL["bfloat16"])


@pytest.mark.parametrize("case", [FLASH_CASES[2], FLASH_CASES[5]],
                         ids=["window64", "window16-softcap"])
def test_bf16_p_rounding_matches_pallas_interpret(case):
    causal, window, softcap, bq, bk = case[6:]
    (jq, jk, jv), (q, k, v) = _inputs(case, "bfloat16", seed=11)
    got = reference_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, p_dtype=torch.bfloat16)
    want = jax_flash(jq, jk, jv, causal=causal, window=window,
                     softcap=softcap, block_q=bq, block_k=bk)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_p_dtype_none_is_unchanged(dtype):
    """``p_dtype=None`` is the plain version as before: float32 softmax
    weights times v, bit for bit."""
    case = FLASH_CASES[1]
    _, (q, k, v) = _inputs(case, dtype, seed=5)
    got = reference_attention(q, k, v, softcap=30.0, p_dtype=None)
    rep = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() / q.shape[3] ** 0.5,
                     torch.repeat_interleave(k, rep, dim=2).float())
    s = 30.0 * torch.tanh(s / 30.0)
    qi = torch.arange(q.shape[1])[:, None]
    ki = torch.arange(k.shape[1])[None, :]
    s = torch.where((ki <= qi)[None, None], s, torch.full_like(s, -1e30))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                        torch.repeat_interleave(v, rep, dim=2).float())
    assert torch.equal(got, want.to(q.dtype))
    assert torch.equal(got, reference_attention(q, k, v, softcap=30.0))


@pytest.mark.parametrize("bad, err", [
    ("dtype", TypeError), ("mixed_dtype", TypeError), ("device", ValueError),
    ("rank", ValueError), ("gqa", ValueError), ("head_dim", ValueError),
    ("kv_shape", ValueError), ("window", ValueError), ("softcap", ValueError),
    ("block", ValueError), ("not_tensor", TypeError),
])
def test_wrapper_rejects(bad, err):
    q = torch.zeros((1, 8, 4, 32))
    k = v = torch.zeros((1, 8, 2, 32))
    kw = {}
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "device":
        q = q.to("meta")
    elif bad == "rank":
        q = q[0]
    elif bad == "gqa":
        k = v = torch.zeros((1, 8, 3, 32))
    elif bad == "head_dim":
        q, k, v = (torch.zeros(t.shape[:3] + (48,)) for t in (q, k, v))
    elif bad == "kv_shape":
        v = torch.zeros((1, 9, 2, 32))
    elif bad == "window":
        kw["window"] = 0
    elif bad == "softcap":
        kw["softcap"] = -1.0
    elif bad == "block":
        kw["block_q"] = 0
    elif bad == "not_tensor":
        q = np.zeros((1, 8, 4, 32), np.float32)
    with pytest.raises(err):
        ops.flash_attention(q, k, v, **kw)
