"""The port's model zoo (``repro_torch.models``) against the JAX
reference, on the CPU: the dense, xLSTM, MoE (grok-1, qwen2-moe), hybrid
mamba (jamba) and encoder-decoder (whisper) families.

Weights are made by the reference (``Model.init``) and carried across with
``Model.params_from_numpy``; inputs come from numpy seeds.  Tolerances:

* float32 params, caches and activations: atol/rtol 1e-4 on logits — the
  same arithmetic, summed in another order by XLA and torch through two
  layers;
* bfloat16 params: the reference's own bf16 tolerance for logits
  (atol 0.15, rtol 0.05, ``tests/test_arch_smoke.py``): bf16 rounds at
  other places in the two frameworks.

``attention_impl="flash"`` on CPU tensors runs the kernel's plain version
in the port and the chunked path in the reference (its off-TPU dispatch).
xlstm-1.3b's mLSTM layers run the chunkwise kernel's plain version in the
port and the reference's jnp chunked scan; its smoke config has one group
of 7 mLSTM + 1 sLSTM layers.  jamba's smoke config is one group of its
8-layer period (mamba everywhere but position 4, MoE on odd positions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as jtf
from repro.models import whisper as jwhisper
from repro.models.model import Model as JModel
from repro.runconfig import RunConfig as JRunConfig
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import common, ssm, transformer, whisper
from repro_torch.models.model import Model
from repro_torch.runconfig import RunConfig

DENSE = ["yi-6b", "qwen1.5-4b", "mistral-nemo-12b", "codeqwen1.5-7b",
         "qwen2-vl-72b"]
PORTED = DENSE + ["xlstm-1.3b", "grok-1-314b", "qwen2-moe-a2.7b",
                  "jamba-1.5-large-398b", "whisper-tiny"]
F32 = dict(param_dtype="float32", activation_dtype="float32",
           kv_cache_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _pair(arch, dtype=jnp.float32, seed=0):
    """(jax model, jax params, port model, port params) with the same
    weights."""
    jm = JModel(jax_smoke(arch))
    jp = jm.init(jax.random.key(seed), dtype=dtype)
    tm = Model(get_smoke_config(arch), device="cpu")
    return jm, jp, tm, tm.params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _inputs(cfg, B, S, seed):
    """Prefill inputs: tokens, and whisper's stub frame embeddings."""
    inputs = {"tokens": _tokens(cfg, B, S, seed)}
    if cfg.is_encoder_decoder:
        inputs["frames"] = np.random.default_rng(seed + 100).standard_normal(
            (B, cfg.encoder_seq, cfg.d_model), np.float32)
    return inputs


def _first_cache(state):
    """The first position's first cache or state leaf."""
    return state.self_k if hasattr(state, "self_k") else state.slots[0][0]


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode_step
# ---------------------------------------------------------------------------

def test_param_tree_matches_reference_layout():
    for arch in PORTED:
        jm = JModel(jax_smoke(arch))
        want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                            jm.param_shapes(jnp.bfloat16))
        tp = Model(get_smoke_config(arch), device="cpu").init(0)
        got = common.tree_map(
            lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tp)
        assert got == want, arch


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_reference(arch):
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(jm.cfg, 2, 11, seed=1)
    if jm.cfg.is_encoder_decoder:          # encode, then the decoder pass
        frames = _inputs(jm.cfg, 2, 11, seed=1)["frames"]
        jrc, trc = JRunConfig(**F32), RunConfig(**F32)
        want = jwhisper.decode_train(
            jp, jnp.asarray(toks),
            jwhisper.encode(jp, jnp.asarray(frames), jm.cfg, jrc), jm.cfg,
            jrc)
        got = whisper.decode_train(
            tp, torch.from_numpy(toks),
            whisper.encode(tp, torch.from_numpy(frames), tm.cfg, trc),
            tm.cfg, trc)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                   rtol=1e-4)
        return
    pos = None
    if jm.cfg.mrope_sections is not None:       # distinct (t, h, w) ids
        pos = np.random.default_rng(2).integers(
            0, 11, size=(3, 2, 11)).astype(np.int32)
    want, jaux = jtf.forward(jp, jnp.asarray(toks), jm.cfg,
                             JRunConfig(**F32),
                             positions=None if pos is None
                             else jnp.asarray(pos))
    got, aux = transformer.forward(tp, torch.from_numpy(toks), tm.cfg,
                                   RunConfig(**F32),
                                   positions=None if pos is None
                                   else torch.from_numpy(pos))
    assert got.dtype == torch.float32
    # the MoE aux loss summed over the stack (0 without MoE layers)
    assert (float(aux) == 0.0) == (float(jaux) == 0.0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl", ["flash", "reference"])
@pytest.mark.parametrize("arch", PORTED)
def test_prefill_then_decode_matches_reference(arch, impl):
    jm, jp, tm, tp = _pair(arch)
    kw = dict(F32, attention_impl=impl, flash_block_k=4)
    jrc, trc = JRunConfig(**kw), RunConfig(**kw)
    inputs = _inputs(jm.cfg, 2, 9, seed=3)
    want, jst = jm.prefill(jp, {k: jnp.asarray(v) for k, v in inputs.items()},
                           16, jrc)
    got, tst = tm.prefill(tp, inputs, 16, trc)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    np.testing.assert_allclose(_np(_first_cache(tst)),
                               _np(_first_cache(jst)), atol=1e-5)
    nxt = _tokens(jm.cfg, 2, 3, seed=4)
    for t in range(3):
        want, jst = jm.decode_step(jp, jnp.asarray(nxt[:, t:t + 1]), jst,
                                   jrc)
        got, tst = tm.decode_step(tp, nxt[:, t:t + 1], tst, trc)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))


def test_bf16_prefill_decode_at_reference_tolerance():
    jm, jp, tm, tp = _pair("yi-6b", dtype=jnp.bfloat16)
    toks = _tokens(jm.cfg, 2, 8, seed=5)
    want, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16,
                           JRunConfig(attention_impl="flash"))
    got, tst = tm.prefill(tp, {"tokens": toks}, 16,
                          RunConfig(attention_impl="flash"))
    np.testing.assert_allclose(_np(got), _np(want), atol=0.15, rtol=0.05)
    want, _ = jm.decode_step(jp, jnp.ones((2, 1), jnp.int32), jst,
                             JRunConfig())
    got, _ = tm.decode_step(tp, np.ones((2, 1), np.int32), tst, RunConfig())
    np.testing.assert_allclose(_np(got), _np(want), atol=0.15, rtol=0.05)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, (1e-4, 1e-4)),
                                        (torch.bfloat16, (0.15, 0.05))],
                         ids=["f32", "bf16"])
def test_decode_matches_forward(dtype, tol):
    """Teacher-forced decode == full forward logits (cache correctness),
    the port's own check, as the reference's test_decode_matches_forward."""
    cfg = get_smoke_config("yi-6b")
    m = Model(cfg, device="cpu")
    params = m.init(0, dtype=dtype)
    rc = RunConfig(**F32) if dtype == torch.float32 else RunConfig()
    toks = torch.from_numpy(_tokens(cfg, 1, 8, seed=6))
    full, _ = transformer.forward(params, toks, cfg, rc)
    state = m.init_decode_state(1, 16, rc)
    outs = []
    for t in range(8):
        logits, state = m.decode_step(params, toks[:, t:t + 1], state, rc)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(_np(dec), _np(full), atol=tol[0],
                               rtol=tol[1])


# ---------------------------------------------------------------------------
# xlstm-1.3b: several chunks, bf16, decode == forward
# ---------------------------------------------------------------------------

def test_xlstm_prefill_over_several_chunks_then_decode():
    """A 12-token prompt in chunks of 4: the mLSTM carry crosses chunks;
    every recurrent state of the prefill matches the reference's."""
    jm, jp, tm, tp = _pair("xlstm-1.3b")
    kw = dict(F32, mlstm_chunk=4)
    jrc, trc = JRunConfig(**kw), RunConfig(**kw)
    toks = _tokens(jm.cfg, 2, 12, seed=7)
    want, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16, jrc)
    got, tst = tm.prefill(tp, {"tokens": toks}, 16, trc)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    for tslot, jslot in zip(tst.slots, jst.slots):
        for a, b in zip(tslot, jslot):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=1e-4)
    nxt = _tokens(jm.cfg, 2, 3, seed=8)
    for t in range(3):
        want, jst = jm.decode_step(jp, jnp.asarray(nxt[:, t:t + 1]), jst,
                                   jrc)
        got, tst = tm.decode_step(tp, nxt[:, t:t + 1], tst, trc)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                   rtol=1e-4)


def test_xlstm_bf16_prefill_decode_at_reference_tolerance():
    """bf16 weights against the reference evaluated op by op
    (``jax.disable_jit``): jitted, XLA keeps fused bf16 intermediates in
    float32 and lands beyond its own bf16 tolerance from its op-by-op
    logits on this prompt; the port rounds where the ops do."""
    jm, jp, tm, tp = _pair("xlstm-1.3b", dtype=jnp.bfloat16)
    toks = _tokens(jm.cfg, 2, 8, seed=5)
    with jax.disable_jit():
        want, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16,
                               JRunConfig(mlstm_chunk=4))
    got, tst = tm.prefill(tp, {"tokens": toks}, 16, RunConfig(mlstm_chunk=4))
    np.testing.assert_allclose(_np(got), _np(want), atol=0.15, rtol=0.05)
    with jax.disable_jit():
        want, _ = jm.decode_step(jp, jnp.ones((2, 1), jnp.int32), jst,
                                 JRunConfig())
    got, _ = tm.decode_step(tp, np.ones((2, 1), np.int32), tst, RunConfig())
    np.testing.assert_allclose(_np(got), _np(want), atol=0.15, rtol=0.05)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, (1e-4, 1e-4)),
                                        (torch.bfloat16, (0.15, 0.05))],
                         ids=["f32", "bf16"])
def test_xlstm_decode_matches_forward(dtype, tol):
    """Teacher-forced decode (the sequential recurrence) == the full
    forward (the chunkwise kernel's plain version, chunks of 4)."""
    cfg = get_smoke_config("xlstm-1.3b")
    m = Model(cfg, device="cpu")
    params = m.init(0, dtype=dtype)
    rc = RunConfig(**F32, mlstm_chunk=4) if dtype == torch.float32 \
        else RunConfig(mlstm_chunk=4)
    toks = torch.from_numpy(_tokens(cfg, 1, 12, seed=6))
    full, _ = transformer.forward(params, toks, cfg, rc)
    state = m.init_decode_state(1, 16, rc)
    outs = []
    for t in range(12):
        logits, state = m.decode_step(params, toks[:, t:t + 1], state, rc)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(_np(dec), _np(full), atol=tol[0],
                               rtol=tol[1])


def test_xlstm_decode_step_updates_states_in_place():
    cfg = get_smoke_config("xlstm-1.3b")
    m = Model(cfg, device="cpu")
    params = m.init(0)
    rc = RunConfig(mlstm_chunk=4)
    _, st = m.prefill(params, {"tokens": _tokens(cfg, 2, 8, seed=9)}, 16,
                      rc)
    before = [t.clone() for slot in st.slots for t in slot]
    _, st2 = m.decode_step(params, np.ones((2, 1), np.int32), st, rc)
    assert st2.slots is st.slots
    after = [t for slot in st2.slots for t in slot]
    assert all(not torch.equal(a, b) for a, b in zip(after, before))


# ---------------------------------------------------------------------------
# the MoE, hybrid and encoder-decoder families
# ---------------------------------------------------------------------------

def test_every_smoke_config_builds_on_the_cpu():
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        m = Model(cfg, device="cpu")
        logits, st = m.prefill(m.init(0), _inputs(cfg, 2, 8, seed=10), 16,
                               RunConfig())
        assert logits.shape == (2, 1, cfg.vocab_size), arch
        logits, st = m.decode_step(m.init(0), np.ones((2, 1), np.int32), st,
                                   RunConfig())
        assert bool(torch.isfinite(logits).all()), arch
        assert st.pos.tolist() == [9, 9], arch


def _full_logits(m, params, inputs, rc):
    cfg = m.cfg
    toks = torch.from_numpy(inputs["tokens"])
    if cfg.is_encoder_decoder:
        mem = whisper.encode(params, torch.from_numpy(inputs["frames"])
                             .to(params["embed"]["tok"].dtype), cfg, rc)
        return whisper.decode_train(params, toks, mem, cfg, rc)
    return transformer.forward(params, toks, cfg, rc)[0]


@pytest.mark.parametrize("dtype, tol", [(torch.float32, (1e-4, 1e-4)),
                                        (torch.bfloat16, (0.15, 0.05))],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b",
                                  "whisper-tiny"])
def test_teacher_forced_decode_matches_forward(arch, dtype, tol,
                                               monkeypatch):
    """A 4-token prefill, then 8 teacher-forced ``decode_step``s: each
    step's logits equal the full-sequence forward's at that position.

    Both packages keep the mamba conv tail in bf16, so in float32 jamba's
    decode reads its conv inputs rounded to bf16 where the forward reads
    them in float32 (a logit gap of 2.7e-2 on this prompt).  Its float32
    case keeps the tail in float32 (``ssm.init_state`` and the prefill's
    final state patched), so the caches and states are held at 1e-4."""
    cfg = get_smoke_config(arch)
    m = Model(cfg, device="cpu")
    params = m.init(0, dtype=dtype)
    rc = RunConfig(**F32) if dtype == torch.float32 else RunConfig()
    if arch == "jamba-1.5-large-398b" and dtype == torch.float32:
        init_state, final_state = ssm.init_state, transformer._ssm_final_state

        def f32_tail(*a, **kw):
            st = init_state(*a, **kw)
            return st._replace(conv=st.conv.float())

        def f32_final(p, h, cfg, rc):
            x = ssm._project(p, h, cfg)[0]
            return final_state(p, h, cfg, rc)._replace(
                conv=x[:, h.shape[1] - (cfg.ssm_conv_width - 1):].float())

        monkeypatch.setattr(ssm, "init_state", f32_tail)
        monkeypatch.setattr(transformer, "_ssm_final_state", f32_final)
    inputs = _inputs(cfg, 1, 12, seed=11)
    full = _full_logits(m, params, inputs, rc)
    pre = dict(inputs, tokens=inputs["tokens"][:, :4])
    if cfg.is_encoder_decoder:
        pre["frames"] = torch.from_numpy(inputs["frames"]).to(dtype)
    logits, state = m.prefill(params, pre, 16, rc)
    outs = [logits[:, 0]]
    for t in range(4, 12):
        logits, state = m.decode_step(params, inputs["tokens"][:, t:t + 1],
                                      state, rc)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, dim=1)),
                               _np(full[:, 3:]), atol=tol[0], rtol=tol[1])


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_smoke_config("yi-6b"))
