"""The port's ``flash_attention`` wrapper against the JAX reference.

On CPU tensors the wrapper computes its plain-torch version; that path is
held against the reference's jnp oracle over every ``FLASH_CASES`` entry
in float32 and bfloat16 at the reference's own tolerances (2e-5 / 2e-2,
``tests/test_kernels.py``), and against the Pallas kernel in interpret
mode on two cases.  The CUDA kernel itself is held against the plain
version on the card by ``test_torch_flash_attention_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import reference_attention as jax_ref
from repro_torch.kernels.flash_attention import ops

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


def test_cpu_path_launches_nothing():
    _, (q, k, v) = _inputs((1, 16, 16, 2, 1, 32), "float32", seed=1)
    before = ops.launches
    ops.flash_attention(q, k, v)
    assert ops.launches == before


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
