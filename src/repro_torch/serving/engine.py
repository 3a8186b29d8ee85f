"""Continuous-batching serving engine: token-granular decode over a slot pool.

The port of the JAX package's ``serving/engine.py`` ``ContinuousEngine``
and ``ServedResult``.  The static-batch ``Engine`` and ``RequestQueue``
wait for the fusion planner (their runtime sampling path goes through
it; ROADMAP Queue 1 item 4).

The engine runs on the card unless the caller passes ``device="cpu"``;
with no GPU and no ``device``, it raises.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.platform import resolve_device
from repro_torch.models import transformer
from repro_torch.models.schema import slot_plan
from repro_torch.runtime.kvcache import FleetOverloadError, RequestsCache


@dataclass
class ServedResult:
    """One finished request, mapped back to its submitter.

    ``prompt`` is the *original* unpadded prompt, ``tokens`` the
    generated continuation, ``padded_len`` the width this request was
    actually served at.
    """

    request_id: int
    prompt: np.ndarray
    prompt_len: int
    tokens: np.ndarray
    padded_len: int = 0

    @property
    def sequence(self) -> np.ndarray:
        """Original prompt + generated tokens, padding stripped."""
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.tokens, np.int32)])


class _LiveRequest:
    """Engine-side record of one slot lease (host bookkeeping only)."""

    __slots__ = ("request_id", "prompt", "max_new", "tokens")

    def __init__(self, request_id: int, prompt: np.ndarray, max_new: int):
        self.request_id = request_id
        self.prompt = prompt
        self.max_new = max_new
        self.tokens: list = []


class ContinuousEngine:
    """Token-granular continuous batching: requests join and leave the
    live decode batch *every step*, not at prefill boundaries.

    The device state is ONE fixed-shape batch cache
    (``transformer.init_cache(cfg, capacity, max_len)``); requests lease
    slots of it through a `RequestsCache` pool (admission, deadline
    eviction, `FleetOverloadError` shed).  Every live slot shares one
    write position, so a step is ONE ``decode_step`` over the whole
    batch.  A new request's prompt is prefilled as a single
    ``(1, max_len)`` row (left-padded so the prompt *ends* at the current
    position; the row attends to its pad tokens, as in the JAX package)
    and scattered into its leased slot in place.

    Sampling flows through the serving runtime's *ragged* sampler
    micro-batch: each step's live logits rows submit as one
    ``softmax.cdf`` flush — 2 generated-kernel launches per step for the
    whole batch, with the inverse-CDF cumsum fused into the flush's
    epilogue (the per-request post-step is one host ``searchsorted``).
    """

    def __init__(self, cfg: ModelConfig, params, capacity: int = 4,
                 max_len: int = 512, runtime=None, pad_id: int = 0,
                 eos_id: "int | None" = None, max_pending: int = 64,
                 device=None):
        mixers = {m for m, _ in slot_plan(cfg)}
        if mixers - {"attn"}:
            raise ValueError(
                f"ContinuousEngine requires attention mixers only, got "
                f"{sorted(mixers)} (recurrent state cannot be re-prefilled "
                "per slot)")
        if cfg.is_encdec:
            raise ValueError("ContinuousEngine does not serve enc-dec models")
        self.device = resolve_device(device)
        if params["embedding"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embedding'].device}, "
                             f"the engine serves on {self.device}")
        self.cfg = cfg
        self.params = params
        self.capacity = int(capacity)
        self.max_len = int(max_len)
        self.runtime = runtime
        self.pad_id = int(pad_id)
        self.eos_id = eos_id
        self.max_pending = int(max_pending)

        self.kv = RequestsCache(self.capacity)
        self.cache = transformer.init_cache(cfg, self.capacity, self.max_len,
                                            device=self.device)
        self.pos = 0                      # uniform filled-column count
        self._slots: list = [None] * self.capacity   # slot -> _LiveRequest
        self._tok = np.full((self.capacity, 1), self.pad_id, np.int32)
        self._pending: deque = deque()    # (rid, prompt, max_new, deadline)
        self._next_id = 0
        self._gen = torch.Generator().manual_seed(0)
        self._steps = 0
        self._generated = 0
        self._pending_shed = 0
        self.done: list = []              # ServedResult, completion order
        self.evicted_ids: list = []

    # -- the two device steps besides decode ------------------------------
    def _admit(self, tokens: torch.Tensor, last_index: int):
        """Prefill one ``(1, max_len)`` row: -> (logits of the prompt's
        last token (1, V), the row's fresh cache)."""
        cache = transformer.init_cache(self.cfg, 1, self.max_len,
                                       device=self.device)
        out = transformer.forward(self.cfg, self.params, {"tokens": tokens},
                                  mode="prefill", cache=cache)
        x_last = out["x"][:, last_index:last_index + 1]
        logits = transformer.logits_from_hidden(self.cfg, self.params, x_last)
        return logits[:, 0], out["cache"]

    def _scatter(self, row_cache: dict, slot: int) -> None:
        """Write a prefilled row cache into its slot of the batch cache,
        in place."""
        for s, leaves in row_cache.items():
            for k, r in leaves.items():
                self.cache[s][k][:, slot] = r[:, 0]

    # -- request intake ---------------------------------------------------
    def submit(self, prompt, max_new: int = 16,
               deadline: "float | None" = None,
               request_id: "int | None" = None) -> int:
        """Queue one prompt; returns its request id.  A full pending
        queue sheds the request with `FleetOverloadError`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not (1 <= prompt.shape[0] < self.max_len):
            raise ValueError(
                f"prompt length {prompt.shape[0]} outside [1, {self.max_len})")
        if len(self._pending) >= self.max_pending:
            self._pending_shed += 1
            raise FleetOverloadError(
                f"pending queue full ({self.max_pending}); request shed")
        if request_id is None:
            request_id = self._next_id
        self._next_id = max(self._next_id, request_id) + 1
        self._pending.append((request_id, prompt, int(max_new), deadline))
        return request_id

    # -- the decode loop --------------------------------------------------
    def _live_slots(self) -> list:
        return [s for s in range(self.capacity) if self._slots[s] is not None]

    def _finish(self, slot: int, evicted: bool = False,
                expired: bool = False) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        self._tok[slot, 0] = self.pad_id
        if evicted:
            self.kv.evict(req.request_id, expired=expired)
            self.evicted_ids.append(req.request_id)
        else:
            self.kv.release(req.request_id)
        self.done.append(ServedResult(
            request_id=req.request_id, prompt=req.prompt,
            prompt_len=int(req.prompt.shape[0]),
            tokens=np.asarray(req.tokens, np.int32),
            padded_len=self.max_len))

    def _admit_pending(self, rows: dict) -> None:
        """FIFO admission: lease slots to queued prompts that fit the
        current uniform position (an empty batch re-anchors the position
        to the first prompt's length).  Each admission is one fixed-
        shape ``(1, max_len)`` prefill + one scatter; its first-token
        logits row joins this step's sampler flush in ``rows``."""
        while self._pending and self.kv.has_free_slot():
            rid, prompt, max_new, deadline = self._pending[0]
            L = int(prompt.shape[0])
            if not self._live_slots() and not rows:
                self.pos = L           # empty batch: re-anchor the clock
            elif L > self.pos:
                break                  # FIFO head waits for pos to grow
            if self.pos >= self.max_len:
                break                  # no room to decode even one token
            self._pending.popleft()
            slot = self.kv.admit(rid, L, deadline=deadline)
            self._slots[slot] = _LiveRequest(rid, prompt, max_new)
            toks = np.full((1, self.max_len), self.pad_id, np.int32)
            toks[0, self.pos - L:self.pos] = prompt
            logits1, row_cache = self._admit(
                torch.from_numpy(toks).to(self.device), self.pos - 1)
            self._scatter(row_cache, slot)
            rows[slot] = logits1[0]

    def _sample_rows(self, rows: dict, temperature: float) -> dict:
        """One token per live row — ONE ragged runtime flush when a
        runtime is attached and temperature > 0 (2 generated launches
        for the whole step), argmax for greedy decoding.  Without a
        runtime the draw stays on the rows' device, as the JAX
        package's ``jax.random.categorical`` does."""
        if not rows:
            return {}
        if temperature == 0.0:
            return {s: int(torch.argmax(r)) for s, r in rows.items()}
        order = sorted(rows)
        seeds = [int(torch.randint(2 ** 62, (), generator=self._gen))
                 for _ in order]
        if self.runtime is not None:
            # one host generator per row, seeded from the engine's (the
            # JAX package splits one key per row): the runtime's
            # inverse-CDF draw runs on the host
            futs = {s: self.runtime.submit_sample(
                rows[s], torch.Generator().manual_seed(seed), temperature)
                for s, seed in zip(order, seeds)}
            self.runtime.flush()
            return {s: int(f.result(timeout=60.0)) for s, f in futs.items()}
        toks = torch.cat([torch.multinomial(
            torch.softmax(rows[s].float() / temperature, dim=-1), 1,
            generator=torch.Generator(rows[s].device).manual_seed(seed))
            for s, seed in zip(order, seeds)])
        return dict(zip(order, toks.tolist()))

    @torch.no_grad()
    def step(self, temperature: float = 0.0) -> int:
        """One uniform decode step: evict expired leases, advance every
        live slot by one token, admit queued requests into freed slots,
        sample all fresh logits rows in one flush.  Returns the number
        of live requests after the step."""
        for rid in self.kv.expired():
            slot = self.kv.slot_of(rid)
            if slot is not None:
                self._finish(slot, evicted=True, expired=True)
        rows: dict = {}
        live = self._live_slots()
        if live:
            logits, self.cache = transformer.decode_step(
                self.cfg, self.params, self.cache,
                torch.from_numpy(self._tok).to(self.device), self.pos)
            self.pos += 1
            for s in live:
                rows[s] = logits[s]
        self._admit_pending(rows)
        toks = self._sample_rows(rows, temperature)
        self._steps += 1
        self._generated += len(toks)
        for s, t in toks.items():
            req = self._slots[s]
            req.tokens.append(t)
            self._tok[s, 0] = t
            if (len(req.tokens) >= req.max_new
                    or (self.eos_id is not None and t == self.eos_id)):
                self._finish(s)
        if self.pos >= self.max_len:
            # cache exhausted: every survivor ends truncated at max_len
            for s in self._live_slots():
                self._finish(s)
        return len(self._live_slots())

    def run(self, temperature: float = 0.0, max_steps: int = 100000) -> list:
        """Step until the pending queue and the live batch drain; ->
        `ServedResult` list in completion order."""
        steps = 0
        while (self._pending or self._live_slots()) and steps < max_steps:
            self.step(temperature=temperature)
            steps += 1
        return self.done

    def result_for(self, request_id: int) -> "ServedResult | None":
        for r in self.done:
            if r.request_id == request_id:
                return r
        return None

    def stats(self) -> dict:
        return {
            "kv": self.kv.stats(),
            "pos": self.pos,
            "steps": self._steps,
            "tokens_generated": self._generated,
            "pending": len(self._pending),
            "pending_shed": self._pending_shed,
            "completed": len(self.done),
            "evicted": len(self.evicted_ids),
        }
