"""Deterministic, stateless synthetic LM data pipeline (from
``repro.train.data``).

``batch_at(seed, step, ...)`` is a pure function: the stream has no
cursor, so a restart at any step reproduces the exact token stream (data
position is part of the checkpoint implicitly, as just the step number).
Each host materializes only its slice of the global batch
(``host_slice``), and on a process mesh each data rank only its rows of
the host's batch (``data_index`` / ``data_count``; the same tokens the
one-process stream has in those rows).  ``data_slice`` cuts a batch
already in memory the same way (M-RoPE ``positions`` [3, B, S] on axis
1).

Documents are drawn from a Zipf(1.1) unigram mixture with a BOS (token 0)
every ``doc_len`` positions, as in the reference, and the draw is the
reference's own: ``jax.random.categorical`` under partitionable threefry
(``jax_threefry_partitionable``, on by default) is the argmax of the
logits plus Gumbel noise ``-log(-log(u))``, ``u`` the float32 uniform
JAX makes from the 32 bits threefry2x32 gives each element's counter
(its flat index).  Those bits are rebuilt here in torch, on the batch's
device, from the key ``fold_in(fold_in(key(seed), step), host_index)``,
by the evaluator's ``core.evaluators.threefry2x32`` (uint32 words in
int64 tensors, masked to 32 bits).  The tokens
equal the reference's except where a one-ulp difference of ``log``
between the two libraries flips a near-tie of the argmax.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.core.evaluators import threefry2x32
from repro_torch.device import resolve_device

_M32 = 0xFFFFFFFF
_CHUNK = 1 << 22               # elements drawn per pass (bounds scratch)


def key(seed: int) -> Tuple[int, int]:
    """``jax.random.key(seed)``'s raw words [seed >> 32, seed & M32]."""
    return (int(seed) >> 32) & _M32, int(seed) & _M32


def fold_in(k: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in``: threefry2x32 of the counter (0, data)."""
    return threefry2x32(k[0], k[1], 0, int(data) & _M32)


def random_bits(k: Tuple[int, int], start: int, n: int,
                device) -> torch.Tensor:
    """The 32-bit words of flat elements [start, start + n) of a
    ``jax.random.bits(k, shape)`` draw (partitionable threefry: element
    i's counter is (i >> 32, i & M32), its word the xor of the two
    outputs), as int64."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k[0], k[1], idx >> 32, idx & _M32)
    return y0 ^ y1


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32 from its uniform's
    32-bit words: the mantissa-fill uniform on [tiny, 1), then
    -log(-log(u))."""
    tiny = torch.finfo(torch.float32).tiny
    f = (((bits >> 9) | 0x3F800000).to(torch.int32)
         .view(torch.float32) - 1.0)
    lo = torch.tensor(tiny, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=bits.device)
    u = torch.maximum(lo, f * (hi - lo) + lo)
    return -torch.log(-torch.log(u))


def _unigram_logits(vocab: int, device) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    return -1.1 * torch.log(ranks)          # Zipf(1.1)


def categorical_rows(k: Tuple[int, int], logits: torch.Tensor,
                     rows: int, first: int = 0) -> torch.Tensor:
    """Rows [first, first + rows) of ``jax.random.categorical(k,
    broadcast(logits, (R, V)))`` (R >= first + rows): int64 [rows], drawn
    ``_CHUNK`` elements at a time."""
    V = logits.shape[0]
    per = max(_CHUNK // V, 1)
    out = []
    for r0 in range(first, first + rows, per):
        r1 = min(first + rows, r0 + per)
        g = gumbel_from_bits(random_bits(k, r0 * V, (r1 - r0) * V,
                                         logits.device))
        out.append(torch.argmax(g.view(r1 - r0, V) + logits, dim=-1))
    return torch.cat(out)


def batch_at(seed: int, step: int, *, global_batch: int, seq_len: int,
             vocab_size: int, doc_len: int = 512, host_index: int = 0,
             host_count: int = 1, data_index: int = 0, data_count: int = 1,
             device: Union[str, torch.device] = "cuda"
             ) -> Dict[str, torch.Tensor]:
    """Return {tokens, labels} int32 [B_host / data_count, S] for (seed,
    step): data rank ``data_index``'s rows of the host's batch — pure,
    made on ``device``."""
    if global_batch % host_count:
        raise ValueError(f"global_batch {global_batch} does not split over "
                         f"{host_count} hosts")
    dev = resolve_device(device)
    b_host = global_batch // host_count
    if b_host % data_count:
        raise ValueError(f"a host batch of {b_host} does not split over "
                         f"{data_count} data ranks")
    r0, r1 = host_slice(b_host, data_index, data_count)
    k = fold_in(fold_in(key(seed), step), host_index)
    logits = _unigram_logits(vocab_size, dev)
    # one extra token so labels are a true shift
    toks = categorical_rows(k, logits, (r1 - r0) * (seq_len + 1),
                            first=r0 * (seq_len + 1)) \
        .view(r1 - r0, seq_len + 1)
    # doc boundaries: token 0 acts as BOS every doc_len positions
    pos = torch.arange(seq_len + 1, device=dev)
    toks = torch.where((pos % doc_len == 0)[None, :], 0, toks)
    toks = toks.to(torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def host_slice(global_batch: int, host_index: int, host_count: int
               ) -> Tuple[int, int]:
    per = global_batch // host_count
    return host_index * per, (host_index + 1) * per


def data_slice(batch: Dict[str, object], index: int, count: int
               ) -> Dict[str, object]:
    """Data rank ``index``'s rows of a batch of ``count`` ranks (every
    leaf [B, ...] on axis 0, M-RoPE ``positions`` [3, B, S] on axis 1, as
    the reference's ``_split_micro`` splits them)."""
    out = {}
    for key, x in batch.items():
        axis = 1 if key == "positions" else 0
        lo, hi = host_slice(x.shape[axis], index, count)
        out[key] = x[:, lo:hi] if axis else x[lo:hi]
    return out


class SyntheticDataset:
    """Thin iterator facade over ``batch_at`` (examples and the train launcher)."""

    def __init__(self, seed: int, global_batch: int, seq_len: int,
                 vocab_size: int, start_step: int = 0,
                 host_index: int = 0, host_count: int = 1,
                 data_index: int = 0, data_count: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        self.seed = seed
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.step = start_step
        self.host_index = host_index
        self.host_count = host_count
        self.data_index = data_index
        self.data_count = data_count
        self.device = resolve_device(device)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = batch_at(self.seed, self.step, global_batch=self.global_batch,
                     seq_len=self.seq_len, vocab_size=self.vocab_size,
                     host_index=self.host_index, host_count=self.host_count,
                     data_index=self.data_index, data_count=self.data_count,
                     device=self.device)
        self.step += 1
        return b
