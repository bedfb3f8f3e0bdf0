"""The port's synthetic data stream (``repro_torch.train.data``) against
the reference's, on the CPU: ``batch_at`` rebuilds
``jax.random.categorical``'s Gumbel draw from threefry2x32 counter-mode
bits in torch, and gives the reference's tokens exactly (no ``log``
difference flipped a token at these sizes, smoke widths and the
vocabularies of qwen1.5 (32000) and yi-6b (64000); on the card
``chip_smoke.py`` makes yi-6b's batches of 2 x 4097 x 64000 draws)."""

import jax
import numpy as np
import pytest
import torch

from repro.train import data as jdata
from repro_torch.core.evaluators import threefry_bits
from repro_torch.train import data as tdata


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,step,B,S,V", [
    (0, 0, 2, 64, 512), (3, 7, 4, 128, 1000), (1, 2, 2, 40, 32000),
    (5, 1, 1, 63, 64000), (2**31 - 1, 11, 2, 33, 257)])
def test_batch_at_gives_the_reference_tokens(seed, step, B, S, V):
    want = jdata.batch_at(seed, step, global_batch=B, seq_len=S,
                          vocab_size=V)
    got = tdata.batch_at(seed, step, global_batch=B, seq_len=S,
                         vocab_size=V, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_host_slices_match_the_reference():
    for host in range(4):
        want = jdata.batch_at(9, 4, global_batch=8, seq_len=16,
                              vocab_size=300, host_index=host, host_count=4)
        got = tdata.batch_at(9, 4, global_batch=8, seq_len=16,
                             vocab_size=300, host_index=host, host_count=4,
                             device="cpu")
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        assert tdata.host_slice(8, host, 4) == jdata.host_slice(8, host, 4)


def test_keys_and_bits_match_jax():
    """fold_in and the counter-mode bits, word for word."""
    k = tdata.fold_in(tdata.key(123), 45)
    want = jax.random.key_data(jax.random.fold_in(jax.random.key(123), 45))
    assert k == tuple(int(x) for x in np.asarray(want))
    bits = tdata.random_bits(k, 0, 1000, "cpu")
    jbits = jax.random.bits(jax.random.wrap_key_data(
        np.asarray(k, np.uint32)), (1000,))
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(jbits).astype(np.int64))
    # counter (0, 0) is the port's numpy threefry_bits
    assert int(bits[0]) == int(threefry_bits(np.asarray([k]))[0])
    # a window of the stream is the same words as the whole draw's
    np.testing.assert_array_equal(tdata.random_bits(k, 400, 77, "cpu"),
                                  bits[400:477])


def test_stream_is_a_pure_function_of_seed_and_step():
    ds = tdata.SyntheticDataset(4, 2, 32, 500, device="cpu")
    first = [next(ds)["tokens"] for _ in range(3)]
    again = tdata.SyntheticDataset(4, 2, 32, 500, start_step=1,
                                   device="cpu")
    assert torch.equal(next(again)["tokens"], first[1])
    b = tdata.batch_at(4, 2, global_batch=2, seq_len=32, vocab_size=500,
                       device="cpu")
    assert torch.equal(b["tokens"], first[2])
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert bool((b["tokens"][:, 0] == 0).all())       # BOS at doc starts
