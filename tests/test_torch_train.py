"""``Model.loss`` and its gradients in the port against
``jax.value_and_grad`` of the reference's ``Model.loss``, on the CPU, for
every architecture's smoke config.

Weights are made by the reference in float32 and carried across with
``Model.params_from_numpy``; tokens, labels, whisper's frames and
qwen2-vl's M-RoPE positions come from numpy seeds.  The port's gradients
come from ``train_loop.loss_and_grads`` (``torch.autograd.grad`` over the
tree's leaves), in ``tree_flatten``'s order, which is ``jax.tree``'s.

Tolerances: loss relative 1e-5; each leaf's gradient relative L2 1e-4.
Two kinds of leaf are held otherwise:

* a leaf whose gradient is zero in exact arithmetic (the attention keys'
  bias: softmax is shift-invariant along a row) holds rounding noise of
  ~1e-9 in both packages; such a leaf is held to absolute L2 1e-6;
* the recurrent stacks, xlstm-1.3b and jamba, amplify rounding in their
  gradients; they are held in ``test_torch_train_xlstm.py`` and
  ``test_torch_train_jamba.py``.

The MoE smoke configs (grok-1, qwen2-moe, jamba) route the same experts in
both packages at these inputs: no routing near-tie needed replaying.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.model import Model as JModel
from repro.runconfig import RunConfig as JRunConfig
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models.common import (tree_flatten, tree_flatten_with_path,
                                       tree_unflatten)
from repro_torch.models.model import Model
from repro_torch.runconfig import RunConfig
from repro_torch.train.train_loop import loss_and_grads

F32 = dict(param_dtype="float32", activation_dtype="float32",
           kv_cache_dtype="float32")
RECURRENT = ("xlstm_1_3b", "jamba_1_5_large_398b")
ARCHS = [a for a in ARCH_IDS if a not in RECURRENT]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(cfg, keep):
    """The config with only the pattern positions ``keep`` (one group
    each): a cut of the smoke config's depth at its widths."""
    return cfg.scaled(n_layers=len(keep),
                      pattern=tuple(cfg.pattern[i] for i in keep))


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0, keep=None):
    """(reference model, its float32 params, port model, the same params
    in the port), made once per architecture (and cut, ``keep``): no test
    changes them."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    if keep is not None:
        jcfg, tcfg = _cut(jcfg, keep), _cut(tcfg, keep)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(seed), dtype=jnp.float32)
    tm = Model(tcfg, device="cpu")
    return jm, jp, tm, tm.params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(cfg, B=2, S=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections is not None:        # (t, h, w) ids of a stub
        t = np.arange(S, dtype=np.int32)
        batch["positions"] = np.stack(
            [np.broadcast_to(t, (B, S)), np.broadcast_to(t // 4, (B, S)),
             np.broadcast_to(t % 4, (B, S))]).astype(np.int32)
    return batch


def _paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _key_path(path):
    """A ``jax.tree_util`` key path as ``tree_flatten_with_path``'s tuple."""
    return tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))
                 for k in path)


def _compare_grads(got, want, rel):
    """Each leaf within relative L2 ``rel`` (absolute L2 1e-6 where the
    reference's gradient is ~0), paired by the same path in both trees."""
    pairs = tree_flatten_with_path(got)[0]
    g_leaves = [g for _, g in pairs]
    w_leaves = jax.tree.leaves(want)
    assert [p for p, _ in pairs] == [
        _key_path(p) for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    bad = []
    for path, g, w in zip(_paths(want), g_leaves, w_leaves):
        w = np.asarray(w, np.float32)
        err = np.linalg.norm(g.float().numpy() - w)
        norm = np.linalg.norm(w)
        if not (err <= rel * norm or (norm < 1e-6 and err <= 1e-6)):
            bad.append((path, float(err / max(norm, 1e-30)), float(norm)))
    assert not bad, bad


def _value_and_grad(jm, jp, batch, rc):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb, rc),
                                      has_aux=True))(jp)


def check_loss_and_grads(arch, grad_rel):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(jm.cfg)
    (jloss, jmet), jgrads = _value_and_grad(jm, jp, batch, JRunConfig(**F32))
    loss, met, grads = loss_and_grads(tm, tp, batch, RunConfig(**F32))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=1e-5, atol=1e-7)
    _compare_grads(grads, jgrads, grad_rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch, 1e-4)


def test_moe_aux_loss_enters_the_gradient():
    """grok-1's loss is nll + aux: the router gets the aux term's
    gradient, as in the reference (checked above); here the aux is
    non-zero, so that comparison is not vacuous."""
    jm, jp, tm, tp = _pair("grok-1-314b")
    loss, met, _ = loss_and_grads(tm, tp, _batch(jm.cfg), RunConfig(**F32))
    assert float(met["aux"]) > 0
    np.testing.assert_allclose(float(loss), float(met["nll"] + met["aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch,leaf_rel,tree_rel",
                         [("yi-6b", 1e-5, 1e-5),
                          ("grok-1-314b", 1e-2, 2e-3)])
def test_bf16_reduce_matches_reference_custom_vjp(arch, leaf_rel, tree_rel):
    """``tp_reduce_dtype="bfloat16"``: every projection rounds its product
    to bf16 and its backward follows the reference's custom VJP (bf16
    cotangent and dgrad, float32 wgrad, operands converted as
    ``jnp.matmul`` converts them); the MoE's down-projection follows
    JAX's own VJP of a bf16-output dot (``MatmulBf16`` with a bf16
    wgrad).  yi-6b agrees to
    2e-6.  In grok-1 one of the MoE layer's 2048 outputs is a float32
    product at a bf16 rounding tie and rounds to the other neighbour (the
    layer alone: gradients within 7e-7); downstream that moves the
    gradients by 1.3e-3 over the tree, so grok-1 is held to 1e-2 per leaf
    and 2e-3 over the tree."""
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(jm.cfg)
    kw = dict(F32, tp_reduce_dtype="bfloat16")
    (jloss, _), jgrads = _value_and_grad(jm, jp, batch, JRunConfig(**kw))
    loss, _, grads = loss_and_grads(tm, tp, batch, RunConfig(**kw))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _compare_grads(grads, jgrads, leaf_rel)
    got = np.concatenate([g.float().numpy().ravel()
                          for g in tree_flatten(grads)[0]])
    want = np.concatenate([np.asarray(w, np.float32).ravel()
                           for w in jax.tree.leaves(jgrads)])
    assert np.linalg.norm(got - want) <= tree_rel * np.linalg.norm(want)


def test_bf16_reduce_backward_rounds_as_the_reference():
    """The custom VJP alone, on one [B,S,in] x [in,out] product."""
    from repro.models.common import _mm_bf16_reduce
    from repro_torch.models.common import MatmulBf16
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal((24, 16)).astype(np.float32)
    g = rng.standard_normal((2, 5, 16)).astype(np.float32)
    _, vjp = jax.vjp(_mm_bf16_reduce, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = MatmulBf16.apply(tx, tw)
    assert y.dtype == torch.bfloat16
    dx, dw = torch.autograd.grad(y, (tx, tw),
                                 torch.from_numpy(g).to(torch.bfloat16))
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    # dx: bf16 operands, rounded to bf16, in both
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-6,
                               atol=1e-6)


def test_bf16_output_dot_backward_rounds_as_jax():
    """``MatmulBf16`` with a bf16 wgrad: JAX's own VJP of a bf16-output
    dot of float32 operands (the MoE's bf16-reduce down-projection): both
    backward products on bf16 operands, rounded to bf16."""
    from repro_torch.models.common import MatmulBf16
    rng = np.random.default_rng(6)
    z = rng.standard_normal((32, 96)).astype(np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    g = rng.standard_normal((32, 40)).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: jnp.matmul(
        a, b, preferred_element_type=jnp.bfloat16), jnp.asarray(z),
        jnp.asarray(w))
    jdz, jdw = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    tz = torch.from_numpy(z).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = MatmulBf16.apply(tz, tw, torch.bfloat16)
    np.testing.assert_array_equal(ty.float().detach().numpy(),
                                  np.asarray(y, np.float32))
    dz, dw = torch.autograd.grad(ty, (tz, tw),
                                 torch.from_numpy(g).to(torch.bfloat16))
    np.testing.assert_array_equal(dz.numpy(), np.asarray(jdz))
    np.testing.assert_array_equal(dw.numpy(), np.asarray(jdw))
