"""Batched serving engine with token-level continuous batching (from
``repro.serve.engine``; the same scheduling).

Orca-style scheduling: one ``decode_step`` advances **all** slots every
iteration; a freshly admitted request replays its prompt through the
same step (prefill-as-decode) while neighbouring slots keep generating —
no global prefill/decode phase barrier.

Mechanics (enabled by the model's per-slot position vector):

* ``DecodeState.pos`` is a [slots] vector on the device — each slot
  attends to exactly its own ``kv_len = pos+1`` prefix, so a recycled slot
  needs no cache zeroing: stale rows sit beyond its kv_len and are masked;
* admission resets ``pos[slot] = 0`` in place on the device and streams
  the prompt tokens in as that slot's per-step input; a recurrent slot
  (mamba, mLSTM, sLSTM) keeps the previous request's state, as in the
  reference;
* emission: a slot in the replay phase discards logits until its prompt is
  consumed, then greedy-decodes; finished slots idle on token 0 until
  recycled;
* admission control: the KV-cache budget (kvcache.py, the
  ``kvcache_hbm_frac`` knob) caps slots × s_max up front.

The step's only host read is the [slots] argmax of the last logits.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.runconfig import RunConfig
from repro_torch.serve.kvcache import CachePlan

IDLE, REPLAY, DECODE = 0, 1, 2


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    admitted_at_step: int = -1
    finished_at_step: int = -1


class Engine:
    def __init__(self, model: Model, params, rc: RunConfig, *,
                 slots: int = 8, s_max: int = 1024, hbm_bytes: float = 16e9,
                 kv_frac: float = 0.3):
        if model.cfg.is_encoder_decoder:
            raise NotImplementedError(
                "engine serves decoder-only stacks; whisper decodes via "
                "Model.decode_step directly (examples/serve_batched.py)")
        self.model, self.params, self.rc = model, params, rc
        self.slots, self.s_max = slots, s_max
        self.plan = CachePlan.build(model.cfg, rc, hbm_bytes=hbm_bytes,
                                    kv_frac=kv_frac)
        if not self.plan.fits(slots, s_max):
            raise ValueError(
                f"kv budget: {slots}x{s_max} needs "
                f"{slots * s_max * self.plan.bytes_per_token_per_seq / 2**30:.2f}"
                f" GiB > {self.plan.budget_bytes / 2**30:.2f} GiB — lower "
                f"slots/s_max or raise kvcache_hbm_frac")
        self.state = model.init_decode_state(slots, s_max, rc)

        self.phase = np.full(slots, IDLE, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.replay_cursor = np.zeros(slots, np.int32)
        self.next_tok = np.zeros((slots, 1), np.int32)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.step_count = 0
        self._rid = 0

    # ---- public API ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) + max_new_tokens > self.s_max:
            raise ValueError("request exceeds s_max")
        rid = self._rid
        self._rid += 1
        self.queue.append(Request(rid, prompt, max_new_tokens))
        return rid

    def run(self, max_steps: int = 100_000) -> List[Request]:
        for _ in range(max_steps):
            if not self.queue and all(p == IDLE for p in self.phase):
                break
            self.step()
        return self.finished

    # ---- one engine iteration ---------------------------------------------------

    def step(self):
        self._admit()
        if all(p == IDLE for p in self.phase):
            return
        logits, self.state = self.model.decode_step(
            self.params, torch.from_numpy(self.next_tok), self.state,
            self.rc)
        argmax = logits[:, -1, :].argmax(dim=-1).to(torch.int32) \
            .cpu().numpy()
        self.step_count += 1
        for s in range(self.slots):
            req = self.slot_req[s]
            if req is None:
                self.next_tok[s, 0] = 0
                continue
            if self.phase[s] == REPLAY:
                self.replay_cursor[s] += 1
                if self.replay_cursor[s] < len(req.prompt):
                    self.next_tok[s, 0] = req.prompt[self.replay_cursor[s]]
                else:
                    self.phase[s] = DECODE        # prompt consumed: emit
                    req.out_tokens.append(int(argmax[s]))
                    self.next_tok[s, 0] = argmax[s]
            else:                                  # DECODE
                req.out_tokens.append(int(argmax[s]))
                self.next_tok[s, 0] = argmax[s]
            if req.out_tokens and (
                    len(req.out_tokens) >= req.max_new_tokens
                    or len(req.prompt) + len(req.out_tokens) >= self.s_max):
                req.done = True
                req.finished_at_step = self.step_count
                self.finished.append(req)
                self.slot_req[s] = None
                self.phase[s] = IDLE
                self.next_tok[s, 0] = 0

    def _admit(self):
        for s in range(self.slots):
            if self.phase[s] != IDLE or not self.queue:
                continue
            req = self.queue.pop(0)
            req.admitted_at_step = self.step_count
            self.slot_req[s] = req
            self.phase[s] = REPLAY
            self.replay_cursor[s] = 0
            self.next_tok[s, 0] = req.prompt[0]
            # recycle the slot: pos -> 0 in place (stale cache rows are
            # masked by the per-slot kv_len; no zeroing needed)
            self.state.pos[s] = 0

    # ---- metrics ------------------------------------------------------------

    def utilization(self) -> float:
        return float(np.mean(self.phase != IDLE))
