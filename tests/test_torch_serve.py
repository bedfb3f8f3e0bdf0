"""The port's continuous-batching engine, KV-cache plan and serve launcher
against the JAX reference, on the CPU.

Token parity runs the smoke configs (yi-6b, xlstm-1.3b, qwen2-moe's MoE
stack, jamba's hybrid mamba/attention/MoE stack) with the reference's
weights carried across in float32, with float32 caches and activations:
the two packages then compute the same logits to float-order noise, and
the greedy tokens must be equal request for request.  Both engines refuse
the encoder-decoder family (whisper).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.train import parse_knobs as jax_parse_knobs
from repro.models.model import Model as JModel
from repro.runconfig import RunConfig as JRunConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.kvcache import CachePlan as JCachePlan
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.runconfig import RunConfig
from repro_torch.serve.engine import Engine
from repro_torch.serve.kvcache import CachePlan

F32 = dict(param_dtype="float32", activation_dtype="float32",
           kv_cache_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=int(rng.integers(2, 9)))
            for _ in range(n)]


@pytest.mark.parametrize("knobs", [{}, {"kv_layout": "bhsd"}],
                         ids=["bshd", "bhsd"])
def test_engine_emits_the_reference_tokens(knobs):
    jm = JModel(jax_smoke("yi-6b"))
    jp = jm.init(jax.random.key(0), dtype=jnp.float32)
    tm = Model(get_smoke_config("yi-6b"), device="cpu")
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    kw = dict(F32, **knobs)
    jeng = JEngine(jm, jp, JRunConfig(**kw), slots=3, s_max=24)
    teng = Engine(tm, tp, RunConfig(**kw), slots=3, s_max=24)
    for prompt in _prompts(jm.cfg, 7, seed=1):
        jeng.submit(prompt, 5)
        teng.submit(prompt, 5)
    want = {r.rid: r for r in jeng.run()}
    got = {r.rid: r for r in teng.run()}
    assert sorted(got) == sorted(want) == list(range(7))
    for rid, r in got.items():
        assert r.out_tokens == want[rid].out_tokens, rid
        assert (r.admitted_at_step, r.finished_at_step) == \
            (want[rid].admitted_at_step, want[rid].finished_at_step)
    assert teng.step_count == jeng.step_count


# ---------------------------------------------------------------------------
# the reference's serving cases (tests/test_runtime.py::TestServe)
# ---------------------------------------------------------------------------

def test_continuous_batching_isolation():
    """A request's output must not depend on its neighbours."""
    cfg = get_smoke_config("yi-6b")
    m = Model(cfg, device="cpu")
    params = m.init(0)
    rc = RunConfig()
    prompt = np.arange(1, 8) % cfg.vocab_size
    eng1 = Engine(m, params, rc, slots=4, s_max=64)
    eng1.submit(prompt, 5)
    solo = eng1.run()[0].out_tokens
    eng2 = Engine(m, params, rc, slots=4, s_max=64)
    for n in (3, 7, 2, 9):
        eng2.submit(np.arange(1, 1 + n) % cfg.vocab_size, 5)
    batched = [r for r in eng2.run() if len(r.prompt) == 7][0].out_tokens
    assert solo == batched


def test_slot_recycling():
    cfg = get_smoke_config("qwen1.5-4b")
    m = Model(cfg, device="cpu")
    eng = Engine(m, m.init(0), RunConfig(), slots=2, s_max=48)
    for _ in range(6):
        eng.submit(np.arange(1, 4), 3)
    done = eng.run()
    assert len(done) == 6
    assert all(len(r.out_tokens) == 3 for r in done)


def test_kv_budget_enforced():
    m = Model(get_smoke_config("yi-6b"), device="cpu")
    with pytest.raises(ValueError):
        Engine(m, m.init(0), RunConfig(), slots=512, s_max=1 << 20,
               hbm_bytes=1e6)


def test_request_longer_than_s_max_is_refused():
    m = Model(get_smoke_config("yi-6b"), device="cpu")
    eng = Engine(m, m.init(0), RunConfig(), slots=2, s_max=16)
    with pytest.raises(ValueError):
        eng.submit(np.arange(1, 12), 6)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-vl-72b", "whisper-tiny"])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "float32"])
def test_cache_plan_arithmetic(arch, kv_dtype):
    cfg = get_config(arch)
    plan = CachePlan.build(cfg, RunConfig(kv_cache_dtype=kv_dtype),
                           hbm_bytes=16e9, kv_frac=0.3)
    ref = JCachePlan.build(jax_config(arch),
                           JRunConfig(kv_cache_dtype=kv_dtype),
                           hbm_bytes=16e9, kv_frac=0.3)
    assert (plan.bytes_per_token_per_seq, plan.budget_bytes) == \
        (ref.bytes_per_token_per_seq, ref.budget_bytes)
    assert plan.fits(plan.max_batch(32768), 32768)
    assert not plan.fits(plan.max_batch(32768) + 1, 32768)
    assert plan.max_seq(8) == ref.max_seq(8)


def test_cache_plan_int8_doubles_capacity():
    cfg = get_config("yi-6b")
    plan = CachePlan.build(cfg, RunConfig(), hbm_bytes=16e9, kv_frac=0.3)
    int8 = CachePlan.build(cfg, RunConfig(kv_cache_dtype="int8"),
                           hbm_bytes=16e9, kv_frac=0.3)
    assert int8.max_batch(32768) >= 2 * plan.max_batch(32768) * 0.9


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pairs", [
    ["attention_impl=flash", "flash_block_q=256", "kvcache_hbm_frac=0.25"],
    ["tensor_parallel=false", "remat_policy=block", "fsdp_shard_params=True"],
])
def test_parse_knobs_matches_reference(pairs):
    assert serve.parse_knobs(pairs) == jax_parse_knobs(pairs)


@pytest.mark.parametrize("knob", [[], ["--knob", "kv_layout=bhsd",
                                       "--knob", "kv_cache_dtype=int8"]],
                         ids=["default", "bhsd-int8"])
def test_launcher_serves_the_default_traffic_on_cpu(knob):
    res = serve.main(["--arch", "yi-6b", "--device", "cpu", *knob])
    assert res["requests"] == 12
    assert res["tokens"] == 12 * 16
    assert all(len(r.out_tokens) == 16 and r.done for r in res["finished"])
    assert res["steps"] > 0


# ---------------------------------------------------------------------------
# xlstm-1.3b: recurrent states in the engine's slots
# ---------------------------------------------------------------------------

def _engines(arch, slots, s_max):
    jm = JModel(jax_smoke(arch))
    jp = jm.init(jax.random.key(0), dtype=jnp.float32)
    tm = Model(get_smoke_config(arch), device="cpu")
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return (JEngine(jm, jp, JRunConfig(**F32), slots=slots, s_max=s_max),
            Engine(tm, tp, RunConfig(**F32), slots=slots, s_max=s_max))


def _xlstm_engines(slots, s_max):
    return _engines("xlstm-1.3b", slots, s_max)


def test_xlstm_engine_emits_the_reference_tokens():
    jeng, teng = _xlstm_engines(3, 24)
    for prompt in _prompts(jeng.model.cfg, 7, seed=2):
        jeng.submit(prompt, 5)
        teng.submit(prompt, 5)
    want = {r.rid: r.out_tokens for r in jeng.run()}
    got = {r.rid: r.out_tokens for r in teng.run()}
    assert got == want and len(got) == 7
    assert teng.step_count == jeng.step_count


def test_recycled_recurrent_slot_keeps_the_previous_state():
    """Admission resets only ``pos`` (the reference's ``Engine._admit``):
    an attention slot's stale rows are masked by its kv_len, but a
    recurrent slot keeps the previous request's (C, n, m) and (c, n, h, m)
    as the next request's initial state.  Both packages do this, and the
    port keeps the reference's tokens."""
    _check_recycled_slot(*_xlstm_engines(1, 24))


def test_recycled_mamba_slot_keeps_the_previous_state():
    """The same for jamba's mamba slots: the SSD state and the conv tail
    of the previous request carry into the next (its attention slot's
    stale rows are masked)."""
    _check_recycled_slot(*_engines("jamba-1.5-large-398b", 1, 24))


def _check_recycled_slot(jeng, teng):
    def f32(t):                 # a jax or torch leaf (bf16 conv tails too)
        return t.float().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(jnp.asarray(t).astype(jnp.float32))

    first, second = _prompts(jeng.model.cfg, 2, seed=3)
    for eng in (jeng, teng):
        eng.submit(first, 3)
        eng.run()
    held = [f32(t) for slot in jeng.state.slots for t in slot]
    for eng in (jeng, teng):
        eng.submit(second, 3)
        eng._admit()
        assert int(eng.state.pos[0]) == 0
    for slot_j, slot_t in zip(jeng.state.slots, teng.state.slots):
        for a, b in zip(slot_j, slot_t):
            np.testing.assert_allclose(f32(b), f32(a), atol=1e-4, rtol=1e-4)
    fresh = [f32(t) for slot in
             teng.model.init_decode_state(1, 24, teng.rc).slots
             for t in slot]
    now = [f32(t) for slot in jeng.state.slots for t in slot]
    assert all(np.array_equal(a, b) for a, b in zip(now, held))
    assert not any(np.array_equal(a, b) for a, b in zip(now, fresh))
    want = jeng.run()[-1].out_tokens
    assert teng.run()[-1].out_tokens == want


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_moe_and_hybrid_engines_emit_the_reference_tokens(arch):
    jeng, teng = _engines(arch, 3, 24)
    for prompt in _prompts(jeng.model.cfg, 7, seed=4):
        jeng.submit(prompt, 5)
        teng.submit(prompt, 5)
    want = {r.rid: r.out_tokens for r in jeng.run()}
    got = {r.rid: r.out_tokens for r in teng.run()}
    assert got == want and len(got) == 7
    assert teng.step_count == jeng.step_count


def test_engine_refuses_whisper_as_the_reference():
    tm = Model(get_smoke_config("whisper-tiny"), device="cpu")
    jm = JModel(jax_smoke("whisper-tiny"))
    for eng, m in ((Engine, tm), (JEngine, jm)):
        with pytest.raises(NotImplementedError, match="decoder-only"):
            eng(m, None, RunConfig(), slots=2, s_max=16)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b"])
def test_launcher_serves_recurrent_and_moe_stacks_on_cpu(arch):
    res = serve.main(["--arch", arch, "--device", "cpu"])
    assert res["requests"] == 12
    assert res["tokens"] == 12 * 16
    assert all(len(r.out_tokens) == 16 and r.done for r in res["finished"])


def test_launcher_serves_xlstm_on_cpu():
    res = serve.main(["--arch", "xlstm-1.3b", "--device", "cpu"])
    assert res["requests"] == 12
    assert res["tokens"] == 12 * 16
    assert all(len(r.out_tokens) == 16 and r.done for r in res["finished"])
