"""The port's whisper encoder-decoder (``repro_torch.models.whisper``) and
the attention options it needs against the JAX reference, on the CPU.

Weights are made by the reference (``Model.init``, whisper-tiny's smoke
config: 2 + 2 layers, d 64, 32 frames) and carried across with
``Model.params_from_numpy``; frames and tokens come from numpy seeds.
Tolerances: float32 atol/rtol 1e-4 on logits (1e-5 on single layers) —
the same arithmetic, summed in another order; bf16 the reference's
(0.15 / 0.05).  ``attention_impl="flash"`` runs the kernel's plain version
in the port and the chunked path in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import whisper as jwhisper
from repro.models.model import Model as JModel
from repro.runconfig import RunConfig as JRunConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, whisper
from repro_torch.models.model import Model
from repro_torch.runconfig import RunConfig

ARCH = "whisper-tiny"
F32 = dict(param_dtype="float32", activation_dtype="float32",
           kv_cache_dtype="float32")
CACHES = {"bshd": dict(F32), "bhsd": dict(F32, kv_layout="bhsd"),
          "int8": dict(F32, kv_cache_dtype="int8"),
          "bhsd-int8": dict(F32, kv_layout="bhsd", kv_cache_dtype="int8")}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _pair(dtype=jnp.float32, seed=0):
    jm = JModel(jax_smoke(ARCH))
    jp = jm.init(jax.random.key(seed), dtype=dtype)
    tm = Model(get_smoke_config(ARCH), device="cpu")
    return jm, jp, tm, tm.params_from_numpy(jax.tree.map(np.asarray, jp))


def _frames(cfg, B, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model), np.float32).astype(dtype)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_sinusoids_match_reference():
    pos = np.array([[0, 5, 17], [3, 1000, 40000]], np.int32)
    np.testing.assert_allclose(
        whisper.sinusoid_at(torch.from_numpy(pos), 64).numpy(),
        np.asarray(jwhisper.sinusoid_at(jnp.asarray(pos), 64)),
        atol=2e-3)             # one float32 ulp of angles up to 4e4 rad
    np.testing.assert_allclose(
        whisper.sinusoid_positions(24, 384, offset=7).numpy(),
        np.asarray(jwhisper.sinusoid_positions(24, 384, offset=7)),
        atol=1e-5)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_encode_and_decode_train_match_reference(impl):
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    frames, toks = _frames(cfg, 2, 1), _tokens(cfg, 2, 9, 2)
    kw = dict(F32, attention_impl=impl, flash_block_k=8)
    jrc, trc = JRunConfig(**kw), RunConfig(**kw)
    jmem = jwhisper.encode(jp, jnp.asarray(frames), jm.cfg, jrc)
    mem = whisper.encode(tp, torch.from_numpy(frames), cfg, trc)
    np.testing.assert_allclose(_np(mem), _np(jmem), atol=1e-4, rtol=1e-4)
    want = jwhisper.decode_train(jp, jnp.asarray(toks), jmem, jm.cfg, jrc)
    got = whisper.decode_train(tp, torch.from_numpy(toks), mem, cfg, trc)
    assert got.dtype == torch.float32 and got.shape == (2, 9,
                                                        cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("cache", list(CACHES))
def test_prefill_then_decode_matches_reference(cache, impl):
    """Prefill (encode, cross K/V into caches, the decoder over the
    prompt) then three decode steps, every logit and cache against the
    reference's, under both cache layouts and the int8-sim cache."""
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    kw = dict(CACHES[cache], attention_impl=impl, flash_block_k=8)
    jrc, trc = JRunConfig(**kw), RunConfig(**kw)
    inputs = {"tokens": _tokens(cfg, 2, 7, 3), "frames": _frames(cfg, 2, 4)}
    want, jst = jm.prefill(jp, {k: jnp.asarray(v) for k, v in inputs.items()},
                           16, jrc)
    got, tst = tm.prefill(tp, inputs, 16, trc)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    for a, b in zip(tst[:4], jst[:4]):
        assert a.shape == b.shape and a.dtype == getattr(torch, str(b.dtype))
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=1e-4)
    nxt = _tokens(cfg, 2, 3, 5)
    for t in range(3):
        want, jst = jm.decode_step(jp, jnp.asarray(nxt[:, t:t + 1]), jst,
                                   jrc)
        got, tst2 = tm.decode_step(tp, nxt[:, t:t + 1], tst, trc)
        assert tst2.self_k is tst.self_k          # updated in place
        tst = tst2
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(_np(tst.self_k), _np(jst.self_k), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))


def test_bf16_prefill_decode_at_reference_tolerance():
    jm, jp, tm, tp = _pair(dtype=jnp.bfloat16)
    cfg = tm.cfg
    inputs = {"tokens": _tokens(cfg, 2, 8, 6), "frames": _frames(cfg, 2, 7)}
    rc = dict(attention_impl="flash")
    jin = {"tokens": jnp.asarray(inputs["tokens"]),
           "frames": jnp.asarray(inputs["frames"]).astype(jnp.bfloat16)}
    want, jst = jm.prefill(jp, jin, 16, JRunConfig(**rc))
    got, tst = tm.prefill(tp, dict(inputs, frames=torch.from_numpy(
        inputs["frames"]).bfloat16()), 16, RunConfig(**rc))
    np.testing.assert_allclose(_np(got), _np(want), atol=0.15, rtol=0.05)
    want, _ = jm.decode_step(jp, jnp.ones((2, 1), jnp.int32), jst,
                             JRunConfig())
    got, _ = tm.decode_step(tp, np.ones((2, 1), np.int32), tst, RunConfig())
    np.testing.assert_allclose(_np(got), _np(want), atol=0.15, rtol=0.05)


def test_decode_under_bhsd_reads_kv_head_count_rows_of_the_memory():
    """The reference's decode takes the visible memory length from
    ``cross_k.shape[2]``: T_enc under "bshd", but the kv-head count under
    "bhsd", so its cross-attention there reads only the first Kh encoder
    rows.  The port keeps that (held against the reference above); here
    it is shown: the step equals one over a memory cut to Kh rows."""
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    rc = RunConfig(**CACHES["bhsd"])
    frames = torch.from_numpy(_frames(cfg, 1, 8))
    state = tm.init_decode_state({"frames": frames}, 1, 8, rc, tp)
    tok = np.ones((1, 1), np.int32)
    got, _ = tm.decode_step(tp, tok, state, rc)
    Kh = cfg.n_kv_heads
    cut = state._replace(cross_k=state.cross_k[:, :, :, :Kh].clone(),
                         cross_v=state.cross_v[:, :, :, :Kh].clone(),
                         self_k=torch.zeros_like(state.self_k),
                         self_v=torch.zeros_like(state.self_v))
    want, _ = tm.decode_step(tp, tok, cut, rc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert Kh < cfg.encoder_seq
    rc = RunConfig(**CACHES["bshd"])        # every row visible
    state = tm.init_decode_state({"frames": frames}, 1, 8, rc, tp)
    full, _ = tm.decode_step(tp, tok, state, rc)
    assert float((full - got).abs().max()) > 1e-2


def test_init_decode_state_takes_both_calls():
    jm, jp, tm, tp = _pair()
    rc = RunConfig(**F32)
    frames = _frames(tm.cfg, 2, 9)
    st = tm.init_decode_state({"frames": frames}, 2, 12, rc, tp)
    jst = jm.init_decode_state({"frames": jnp.asarray(frames)}, 2, 12,
                               JRunConfig(**F32), jp)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=1e-4)
    st2 = tm.init_decode_state({"frames": frames}, 2, 12, rc, params=tp)
    assert all(torch.equal(a, b) for a, b in zip(st, st2))


# ---------------------------------------------------------------------------
# the attention options whisper needs
# ---------------------------------------------------------------------------

def _attn_pair(seed=0):
    jcfg = jax_smoke(ARCH)
    jp = jattn.init(jax.random.key(seed), jcfg, jnp.float32)
    tp = {k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
          for k, v in jax.tree.map(np.asarray, jp).items()}
    return jcfg, jp, get_smoke_config(ARCH), tp


@pytest.mark.parametrize("impl", ["reference", "chunked", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_apply_with_kv_override_and_no_rope(causal, impl):
    jcfg, jp, cfg, tp = _attn_pair(1)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, cfg.d_model), np.float32)
    mem = rng.standard_normal((2, 10, cfg.d_model), np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    mpos = np.tile(np.arange(10, dtype=np.int32), (2, 1))
    kw = dict(F32, attention_impl=impl, chunk_size_k=4, flash_block_k=4)
    jk, jv = jattn.project_kv(jp, jnp.asarray(mem), jnp.asarray(mpos), jcfg,
                              use_rope=False)
    tk, tv = attention.project_kv(tp, torch.from_numpy(mem),
                                  torch.from_numpy(mpos), cfg,
                                  use_rope=False)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    want = jattn.apply(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                       JRunConfig(**kw), causal=causal,
                       kv_override=(jk, jv), use_rope=False)
    got = attention.apply(tp, torch.from_numpy(x), torch.from_numpy(pos),
                          cfg, RunConfig(**kw), causal=causal,
                          kv_override=(tk, tv), use_rope=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # self-attention without rope, the encoder's and decoder's
    want = jattn.apply(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                       JRunConfig(**kw), causal=causal, use_rope=False)
    got = attention.apply(tp, torch.from_numpy(x), torch.from_numpy(pos),
                          cfg, RunConfig(**kw), causal=causal,
                          use_rope=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("cache", list(CACHES))
def test_decode_apply_cross_matches_reference(cache):
    """One-token cross-attention against a cache of encoder memory (no
    update), ``cross_len`` rows visible."""
    jcfg, jp, cfg, tp = _attn_pair(2)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 1, cfg.d_model), np.float32)
    mem_k = rng.standard_normal((2, 10, cfg.n_kv_heads,
                                 cfg.resolved_head_dim), np.float32)
    mem_v = rng.standard_normal(mem_k.shape, np.float32)
    jrc, trc = JRunConfig(**CACHES[cache]), RunConfig(**CACHES[cache])
    jck, jcv = jattn.init_cache(2, 10, jcfg, jrc)
    jck = jattn.fill_cache(jck, jnp.asarray(mem_k), jrc)
    jcv = jattn.fill_cache(jcv, jnp.asarray(mem_v), jrc)
    tck, tcv = attention.init_cache(2, 10, cfg, trc)
    attention.fill_cache(tck, torch.from_numpy(mem_k), trc)
    attention.fill_cache(tcv, torch.from_numpy(mem_v), trc)
    before = tck.clone()
    for cross_len in (10, 7):
        want, _, _ = jattn.decode_apply(jp, jnp.asarray(x), jck, jcv, 3,
                                        jcfg, jrc, cross=True,
                                        cross_len=cross_len, use_rope=False)
        got, _, _ = attention.decode_apply(tp, torch.from_numpy(x), tck,
                                           tcv, 3, cfg, trc, cross=True,
                                           cross_len=cross_len,
                                           use_rope=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    assert torch.equal(tck, before)
    np.testing.assert_allclose(
        _np(attention.read_cache_full(tck, trc)),
        _np(jattn.read_cache_full(jck, jrc)), atol=0)


@pytest.mark.parametrize("offset", [0, 3])
def test_masks_take_the_query_offset(offset):
    rng = np.random.default_rng(13)
    q = rng.standard_normal((1, 5, 4, 16), np.float32)
    k = rng.standard_normal((1, 9, 2, 16), np.float32)
    v = rng.standard_normal((1, 9, 2, 16), np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for window in (None, 3):
        kw = dict(causal=True, window=window, softcap=None, offset=offset)
        want = jattn.reference_attention(jq, jk, jv, **kw)
        np.testing.assert_allclose(
            attention.reference_attention(tq, tk, tv, **kw).numpy(),
            np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(
            attention.chunked_attention(tq, tk, tv, chunk=4, **kw).numpy(),
            np.asarray(jattn.chunked_attention(jq, jk, jv, chunk=4, **kw)),
            atol=1e-5)
        np.testing.assert_allclose(
            attention.chunked_attention(tq, tk, tv, chunk=4, **kw).numpy(),
            np.asarray(want), atol=1e-5)
