"""Checkpoints across the two packages, on the CPU: the port's
``CheckpointManager`` writes the reference's layout (``step_XXXXXXXX/
manifest.json`` + ``shard_00000.npz``, leaves in ``jax.tree.flatten``'s
order, bf16 as raw uint16 bits), so a train state written by either
package restores in the other, bit for bit, and the next step agrees
(the tolerances of ``test_torch_train_step.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.model import Model as JModel
from repro.runconfig import RunConfig as JRunConfig
from repro.train import train_loop as jtl
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.models.common import tree_flatten
from repro_torch.models.model import Model
from repro_torch.runconfig import RunConfig
from repro_torch.train import train_loop as ttl
from repro_torch.train.checkpoint import CheckpointManager

ARCH = "qwen1.5-4b"
F32 = dict(param_dtype="float32", activation_dtype="float32",
           kv_cache_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models():
    return JModel(jax_smoke(ARCH)), Model(get_smoke_config(ARCH),
                                          device="cpu")


def _batch(cfg, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_state(jm, rc, f32):
    state = jtl.init_state(jm, jax.random.key(1), rc)
    if f32:
        from repro.train import optimizer as jopt
        params = jax.tree.map(lambda x: x.astype(jnp.float32), state.params)
        state = jtl.TrainState(params, jopt.opt_init(params, rc), state.step)
    return state


def _equal_leaves(tstate, jstate):
    t_leaves = tree_flatten(tstate)[0]
    j_leaves = jax.tree.leaves(jstate)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                j.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), j)


def _next_step_close(tm, tstate, jm, jstate, rc_kw):
    batch = _batch(jm.cfg)
    jnew, jmet = jax.jit(jtl.make_train_step(jm, JRunConfig(**rc_kw)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tmet = ttl.make_train_step(tm, RunConfig(**rc_kw))(tstate, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert int(tnew.step) == int(jnew.step)
    for t, (path, j) in zip(tree_flatten(tnew.params)[0],
                            jax.tree_util.tree_flatten_with_path(
                                jnew.params)[0]):
        err = np.abs(t.float().numpy() - np.asarray(j, np.float32))
        name = jax.tree_util.keystr(path)
        if not name.endswith("['k']['b']"):      # zero-gradient leaf
            assert np.sum(err > 1e-5) <= max(1, 1e-3 * err.size), name


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, f32):
    jm, tm = _models()
    rc_kw = dict(F32) if f32 else {}
    jrc = JRunConfig(**rc_kw)
    jstate = _jax_state(jm, jrc, f32)
    # one step so the optimizer state is not all zeros
    jstate, _ = jax.jit(jtl.make_train_step(jm, jrc))(
        jstate, {k: jnp.asarray(v) for k, v in _batch(jm.cfg, 9).items()})
    JCheckpointManager(str(tmp_path)).save(1, jstate)
    template = ttl.init_state(
        tm, 0, RunConfig(**rc_kw),
        params=tm.init(0, dtype=torch.float32 if f32 else torch.bfloat16))
    tstate, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 1
    _equal_leaves(tstate, jstate)
    if f32:
        _next_step_close(tm, tstate, jm, jstate, rc_kw)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, f32):
    jm, tm = _models()
    rc_kw = dict(F32) if f32 else {}
    trc = RunConfig(**rc_kw)
    tstate = ttl.init_state(
        tm, 2, trc,
        params=tm.init(2, dtype=torch.float32 if f32 else torch.bfloat16))
    tstate, _ = ttl.make_train_step(tm, trc)(tstate, _batch(tm.cfg, 9))
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tstate, blocking=False)
    # the write must land before another manager opens the directory:
    # a manager's constructor collects unfinished ``.tmp`` directories
    cm.wait()
    jtemplate = _jax_state(jm, JRunConfig(**rc_kw), f32)
    jstate, step = JCheckpointManager(str(tmp_path)).restore(jtemplate)
    assert step == 1
    _equal_leaves(tstate, jstate)
    if f32:
        _next_step_close(tm, tstate, jm, jstate, rc_kw)


def test_resume_is_bit_equal_to_the_uninterrupted_run(tmp_path):
    """Save at step 2, restore, run step 3: the same bits as running on."""
    _, tm = _models()
    rc = RunConfig(microbatch=1)
    step = ttl.make_train_step(tm, rc)
    batches = [_batch(tm.cfg, s) for s in range(3)]
    state = ttl.init_state(tm, 0, rc)
    cm = CheckpointManager(str(tmp_path))
    for i in range(2):
        state, _ = step(state, batches[i])
    cm.save(2, state)
    straight, m1 = step(state, batches[2])
    restored, at = cm.restore(ttl.init_state(tm, 5, rc))
    assert at == 2
    resumed, m2 = step(restored, batches[2])
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_flatten(straight)[0], tree_flatten(resumed)[0]))


def test_retention_tmp_gc_and_mismatch(tmp_path):
    _, tm = _models()
    state = ttl.init_state(tm, 0, RunConfig())
    (tmp_path / "step_00000009.tmp").mkdir()
    cm = CheckpointManager(str(tmp_path), keep_last=2, keep_every=2)
    assert not (tmp_path / "step_00000009.tmp").exists()
    for s in (1, 2, 3, 4, 5):
        cm.save(s, {"x": torch.full((3,), float(s))}, blocking=False)
    cm.wait()
    assert cm.steps() == [2, 4, 5]
    restored, at = cm.restore({"x": torch.zeros(3)})
    assert at == 5 and restored["x"].tolist() == [5.0] * 3
    with pytest.raises(ValueError, match="leaves"):
        cm.restore(state)
    with pytest.raises(ValueError, match="shape"):
        cm.restore({"x": torch.zeros(4)})
