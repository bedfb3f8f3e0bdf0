"""The port's train step and optimizers against the reference's, on the
CPU: ``make_train_step`` for one step per family (the dense, MoE and
encoder-decoder ones here; the recurrent ones, jamba and xlstm-1.3b, in
``test_torch_train_xlstm.py`` and ``test_torch_train_jamba.py``), the
AdamW and Adafactor updates alone, and the remat policies.

Weights are made by the reference in float32 and carried across with
``Model.params_from_numpy`` (``test_torch_train._pair``); batches come
from numpy seeds.  One step of
the reference's ``make_train_step`` (jitted) and of the port's from the
same state, at lr 1e-3 (one reference step per microbatch setting:
``allreduce_per_microbatch`` changes nothing in the reference under
float32 gradients): the loss, its parts and the learning rate within
1e-5 relative, the gradient norm within 1e-5 (xlstm-1.3b 1e-4: its stack
amplifies rounding, ``test_torch_train.py``) and Adam's first moment (the
scaled gradient) within 1e-3 relative.  Parameters: Adam's first step
moves an element by lr·g/(|g| + 1e-8), ±lr whatever the rounding for
most elements; where |g| is within a few eps of zero, rounding noise
sets the fraction of lr (over these families one element in 8192 moved
by up to 9e-4).  So in every leaf all elements but 0.1 % (at least one)
are held to atol 1e-5, and every element to 2 lr.  The attention keys' bias has a
gradient of zero in exact arithmetic (softmax is shift-invariant along a
row), so its whole update is rounding noise: it is held to 2 lr only.
The optimizer updates alone agree to 1e-6 over three steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runconfig import RunConfig as JRunConfig
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch.configs import get_smoke_config
from repro_torch.models.common import tree_flatten, tree_map
from repro_torch.models.model import Model
from repro_torch.runconfig import RunConfig
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl
from test_torch_train import _pair

F32 = dict(param_dtype="float32", activation_dtype="float32",
           kv_cache_dtype="float32")
FAMILIES = ["yi-6b", "qwen2-moe-a2.7b", "whisper-tiny"]
STEP_KNOBS = {"mb0": dict(microbatch=0),
              "mb1": dict(microbatch=1, allreduce_per_microbatch=False),
              "mb1-per-micro": dict(microbatch=1,
                                    allreduce_per_microbatch=True)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, B=2, S=8, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _assert_tree_close(got, want, atol=1e-5, rtol=1e-5, zero_grad_atol=None):
    """Leaf by leaf; ``zero_grad_atol`` replaces ``atol`` on the keys'
    bias (a leaf whose gradient is zero in exact arithmetic)."""
    g_leaves = tree_flatten(got)[0]
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(g_leaves) == len(flat)
    for g, (path, w) in zip(g_leaves, flat):
        name = jax.tree_util.keystr(path)
        tol = atol
        if zero_grad_atol is not None and name.endswith("['k']['b']"):
            tol, rtol = zero_grad_atol, 0.0
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=tol, rtol=rtol, err_msg=name)


def _assert_params_close(got, want, lr):
    """Every element within 2 lr; in every leaf but the keys' bias, all
    elements but 0.1 % (at least one) within atol 1e-5 (module
    docstring)."""
    g_leaves = tree_flatten(got)[0]
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(g_leaves) == len(flat)
    for g, (path, w) in zip(g_leaves, flat):
        name = jax.tree_util.keystr(path)
        err = np.abs(g.float().numpy() - np.asarray(w, np.float32))
        assert err.max(initial=0.0) <= 2 * lr, name
        if not name.endswith("['k']['b']"):
            assert np.sum(err > 1e-5) <= max(1, 1e-3 * err.size), \
                (name, err.max())


@functools.lru_cache(maxsize=None)
def _reference_step(arch, microbatch, keep=None, extra=()):
    """The reference's jitted step from ``_pair``'s weights: (new state,
    metrics).  With float32 gradients ``allreduce_per_microbatch`` on and
    off accumulate in float32 alike, so one reference step (bulk) holds
    the port's step with either value.  ``extra``: further RunConfig
    knobs, as sorted (name, value) pairs."""
    jm, jp, _, _ = _pair(arch, keep=keep)
    jrc = JRunConfig(**F32, learning_rate=1e-3, microbatch=microbatch,
                     **dict(extra))
    jstate = jtl.TrainState(jp, jopt.opt_init(jp, jrc),
                            jnp.zeros((), jnp.int32))
    step = jax.jit(jtl.make_train_step(
        jm, jrc, lr_schedule=jopt.cosine_schedule(1e-3, 0, 100)))
    return step(jstate, {k: jnp.asarray(v)
                         for k, v in _batch(jm.cfg).items()})


def check_train_step(arch, knobs, keep=None, extra=None):
    """One step of each package from the same state (``keep``: the
    pattern positions of a depth cut, ``test_torch_train._cut``;
    ``extra``: further RunConfig knobs for both, e.g. remat, attention,
    optimizer).  AdamW's first moment is held, or Adafactor's row, column
    and full second moments."""
    extra = dict(extra or {})
    kw = dict(F32, learning_rate=1e-3, **STEP_KNOBS[knobs], **extra)
    jm, _, tm, tp = _pair(arch, keep=keep)
    trc = RunConfig(**kw)
    tstate = ttl.init_state(tm, 0, trc, params=tp)
    batch = _batch(jm.cfg)
    jnew, jmet = _reference_step(arch, kw["microbatch"], keep,
                                 tuple(sorted(extra.items())))
    tnew, tmet = ttl.make_train_step(
        tm, trc, lr_schedule=topt.cosine_schedule(1e-3, 0, 100))(tstate,
                                                                  batch)
    for key in ("loss", "grad_norm", "nll", "aux", "lr"):
        rtol = 1e-4 if key == "grad_norm" and arch == "xlstm-1.3b" else 1e-5
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=rtol, atol=1e-7, err_msg=key)
    assert int(tnew.step) == int(jnew.step) == 1
    _assert_params_close(tnew.params, jnew.params, lr=1e-3)
    moments = ("m",) if trc.optimizer == "adamw" else ("vr", "vc", "v")
    for name in moments:
        _assert_tree_close(getattr(tnew.opt_state, name),
                           getattr(jnew.opt_state, name), atol=1e-6,
                           rtol=1e-3, zero_grad_atol=1e-6)


@pytest.mark.parametrize("knobs", list(STEP_KNOBS), ids=list(STEP_KNOBS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch, knobs):
    check_train_step(arch, knobs)


def test_split_micro_moves_the_positions_batch_axis():
    """``positions`` [3, B, S] splits along its batch axis (axis 1), as
    the reference's ``_split_micro`` splits it."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 9, (4, 5)).astype(np.int32),
             "positions": rng.integers(0, 9, (3, 4, 5)).astype(np.int32)}
    want = jtl._split_micro({k: jnp.asarray(v) for k, v in batch.items()}, 2)
    got = ttl._split_micro({k: torch.from_numpy(v)
                            for k, v in batch.items()}, 2)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tuple(got["positions"].shape) == (2, 3, 2, 5)


def test_accumulation_unroll_gives_the_same_numbers():
    """``grad_accum_unroll`` on and off: the same step, bit for bit."""
    tm = Model(get_smoke_config("yi-6b"), device="cpu")
    batch = _batch(tm.cfg, B=4)
    out = []
    for unroll in (False, True):
        rc = RunConfig(**F32, microbatch=1, grad_accum_unroll=unroll)
        state = ttl.init_state(tm, 0, rc,
                               params=tm.init(0, dtype=torch.float32))
        new, met = ttl.make_train_step(tm, rc)(state, batch)
        out.append((tree_flatten(new.params)[0], float(met["loss"])))
    assert out[0][1] == out[1][1]
    assert all(torch.equal(a, b) for a, b in zip(out[0][0], out[1][0]))


def test_donated_step_equals_the_functional_step():
    """``donate=True`` writes the new state into the old tensors: the
    same numbers as the functional step."""
    tm = Model(get_smoke_config("qwen1.5-4b"), device="cpu")
    rc = RunConfig(microbatch=1)                 # bf16 params, f32 master
    batch = _batch(tm.cfg, B=2)
    res = []
    for donate in (False, True):
        state = ttl.init_state(tm, 3, rc)
        step = ttl.make_train_step(tm, rc, donate=donate)
        for _ in range(2):
            state, met = step(state, batch)
        res.append(tree_flatten(state)[0])
    assert all(torch.equal(a, b) for a, b in zip(*res))


# ---------------------------------------------------------------------------
# the optimizers alone
# ---------------------------------------------------------------------------

def _tree(rng):
    """A parameter-like tree: matrices, a stacked 3-D leaf, vectors."""
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": [{"k": rng.standard_normal((2, 4, 3))
                        .astype(np.float32),
                        "b": rng.standard_normal((3,)).astype(np.float32)}],
            "scale": rng.standard_normal((7,)).astype(np.float32)}


@pytest.mark.parametrize("master", [True, False])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(optimizer, master):
    rng = np.random.default_rng(7)
    params = _tree(rng)
    kw = dict(optimizer=optimizer, master_weights_f32=master,
              grad_clip_norm=0.5, weight_decay=0.1)
    jrc, trc = JRunConfig(**kw), RunConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js, ts = jopt.opt_init(jp, jrc), topt.opt_init(tp, trc)
    for step in range(3):
        grads = _tree(rng)
        lr_j = jopt.cosine_schedule(1e-2, 2, 10)(js.step)
        lr_t = topt.cosine_schedule(1e-2, 2, 10)(ts.step)
        np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-7)
        jp, js = jopt.opt_update(jax.tree.map(jnp.asarray, grads), js, jp,
                                 jrc, lr_j)
        tp, ts = topt.opt_update(tree_map(torch.from_numpy, grads), ts, tp,
                                 trc, lr_t)
        _assert_tree_close(tp, jp, atol=1e-6, rtol=1e-6)
        _assert_tree_close(ts, js, atol=1e-6, rtol=1e-6)


def test_schedules_and_clipping_match_reference():
    for kind in ("cosine_schedule", "linear_schedule"):
        js, ts = getattr(jopt, kind)(3e-4, 10, 100), \
            getattr(topt, kind)(3e-4, 10, 100)
        for step in (0, 1, 5, 10, 11, 57, 100, 150):
            np.testing.assert_allclose(float(ts(step)), float(js(step)),
                                       rtol=1e-7)
    rng = np.random.default_rng(2)
    g = _tree(rng)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tn = topt.clip_by_global_norm(tree_map(torch.from_numpy, g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_tree_close(tc, jc, atol=1e-7, rtol=1e-6)


def test_opt_state_axes_match_reference():
    axes = {"w": ("embed", "mlp"), "layers": [{"k": (None, "embed", "kv"),
                                               "b": ("kv",)}],
            "scale": ("embed",)}
    for optimizer in ("adamw", "adafactor"):
        for master in (True, False):
            kw = dict(optimizer=optimizer, master_weights_f32=master)
            want = jopt.opt_state_axes(axes, JRunConfig(**kw))
            got = topt.opt_state_axes(axes, RunConfig(**kw))
            assert type(got).__name__ == type(want).__name__
            assert tuple(got) == tuple(want)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b"])
def test_remat_policies_give_bit_equal_gradients(arch):
    """none / full / block / dots: the same loss and gradients, bit for
    bit (the recompute runs the same kernels on the same inputs)."""
    tm = Model(get_smoke_config(arch), device="cpu")
    params = tm.init(1, dtype=torch.float32)
    batch = _batch(tm.cfg, S=16)
    out = {}
    for policy in ("none", "full", "block", "dots"):
        rc = RunConfig(**F32, remat_policy=policy)
        loss, _, grads = ttl.loss_and_grads(tm, params, batch, rc)
        out[policy] = (loss, tree_flatten(grads)[0])
    for policy in ("full", "block", "dots"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        assert all(torch.equal(a, b) for a, b in
                   zip(out[policy][1], out["none"][1])), policy


def test_remat_recomputes_under_checkpoint(monkeypatch):
    """Under ``full`` each group's forward runs twice (forward and
    recompute); under ``none`` once."""
    from repro_torch.models import transformer
    calls = []
    real = transformer._block_forward

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(transformer, "_block_forward", counting)
    tm = Model(get_smoke_config("yi-6b"), device="cpu")
    params = tm.init(1, dtype=torch.float32)
    batch = _batch(tm.cfg)
    n_blocks = tm.cfg.n_groups * len(tm.cfg.pattern)
    for policy, want in (("none", n_blocks), ("full", 2 * n_blocks)):
        calls.clear()
        ttl.loss_and_grads(tm, params, batch,
                           RunConfig(**F32, remat_policy=policy))
        assert len(calls) == want, policy
