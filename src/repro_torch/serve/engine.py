"""Batched LM serving of the port: continuous-batching decode over a
shared cache, with the reference's scheduling kept step for step.

A fixed pool of ``max_batch`` slots; requests are admitted into free slots,
each prompt but its last token is fed through one ``decode_step`` per token
(``_step_single``), and every ``tick`` runs one ``decode_step`` for all
slots; a finished sequence frees its slot at once.  Two quirks of the
reference are kept on purpose, so that the tokens equal its tokens
(ROADMAP C8):

* ``tick`` decodes every slot at one shared ``pos = max(lengths)``, so a
  shorter sequence writes its K/V at that position, not at its own length;
* ``_step_single`` decodes the whole batch, so every other slot's cache row
  takes a pad token's K/V (token 0) at the prompt positions.

The decode step runs eagerly on the params' device (CUDA graphs are later
work); greedy picks the argmax, a temperature samples on the host with
numpy as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    eos_token: int = 0
    temperature: float = 0.0  # 0 = greedy


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False


class ServeEngine:
    """``ServeEngine(params, cfg, ServeConfig(...))``; ``params`` is an
    ``LM`` from ``init_params`` or ``params_from_numpy``, and the engine
    runs where the params live."""

    def __init__(self, params: M.LM, cfg: ModelConfig, scfg: ServeConfig,
                 dtype=torch.float32):
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.device = params.device
        self.cache = M.init_cache(cfg, scfg.max_batch, scfg.max_len, dtype,
                                  self.device)
        self.lengths = np.zeros(scfg.max_batch, dtype=np.int64)
        self.active: list[Optional[_Request]] = [None] * scfg.max_batch
        self.queue: list[_Request] = []
        self._rid = 0

    def _decode(self, toks: np.ndarray, pos: int) -> torch.Tensor:
        logits, self.cache = M.decode_step(
            self.params, self.cfg, self.cache,
            torch.as_tensor(toks, device=self.device), pos)
        return logits

    def submit(self, prompt: np.ndarray, max_new: int) -> int:
        self._rid += 1
        self.queue.append(_Request(self._rid, np.asarray(prompt), max_new))
        return self._rid

    # -- internals -----------------------------------------------------------

    def _admit(self):
        for slot in range(self.scfg.max_batch):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                req.slot = slot
                self.active[slot] = req
                # prefill: feed prompt tokens one step at a time through the
                # shared cache (every row decodes; only this slot's is kept)
                for i, tok in enumerate(req.prompt[:-1]):
                    self._step_single(slot, int(tok), i)
                self.lengths[slot] = max(len(req.prompt) - 1, 0)

    def _step_single(self, slot: int, token: int, pos: int):
        toks = np.zeros((self.scfg.max_batch, 1), np.int32)
        toks[slot, 0] = token
        self._decode(toks, pos)

    def tick(self) -> list[tuple[int, list[int]]]:
        """One engine step; returns finished (rid, tokens) pairs."""
        self._admit()
        live = [r for r in self.active if r is not None]
        if not live:
            return []
        toks = np.zeros((self.scfg.max_batch, 1), np.int32)
        for r in live:
            last = (r.out[-1] if r.out else int(r.prompt[-1]))
            toks[r.slot, 0] = last
        # one shared pos for every slot (ROADMAP C8)
        pos = int(max(self.lengths[r.slot] for r in live))
        logits = self._decode(toks, pos)
        logits = logits[:, 0, : self.cfg.vocab].cpu().numpy()
        finished = []
        for r in live:
            if self.scfg.temperature <= 0:
                nxt = int(np.argmax(logits[r.slot]))
            else:
                z = logits[r.slot] / self.scfg.temperature
                p = np.exp(z - z.max())
                p /= p.sum()
                nxt = int(np.random.default_rng(len(r.out)).choice(p.size, p=p))
            r.out.append(nxt)
            self.lengths[r.slot] += 1
            if (
                nxt == self.scfg.eos_token
                or len(r.out) >= r.max_new
                or self.lengths[r.slot] >= self.scfg.max_len - 1
            ):
                finished.append((r.rid, r.out))
                self.active[r.slot] = None  # slot freed -> continuous batching
        return finished

    def run_to_completion(self, max_ticks: int = 10_000):
        done = []
        for _ in range(max_ticks):
            done.extend(self.tick())
            if not self.queue and all(a is None for a in self.active):
                break
        return done
