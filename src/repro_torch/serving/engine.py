"""Multi-tenant adapter-switching serving engine — the inference-time dual
of the paper's training framework.  Port of ``src/repro/serving/engine.py``.

The paper's server keeps ONE resident base model and sequentially switches
per-client LoRA adapters.  At serving time the same memory economics apply:
N tenants (clients) each own a fine-tuned adapter set, the engine keeps the
base resident, batches requests WITHIN a tenant (adapters are batch-uniform
arguments of the step), and round-robins BETWEEN tenants,
longest-backlog-first (Alg. 2's hide-the-stragglers logic).

Lockstep batching over fixed decode slots: requests are admitted into the
free slots of the tenant's slot batch, their prompts replayed token by
token through ``serve_step`` into the slot's cache row, then decoded until
EOS / max_new_tokens; all slots share one position, so new work is
admitted only when the whole batch has drained.  One ``serve_step`` per
(arch, slot batch, cache_len) serves every tenant; switching adapters
switches arguments only.

Greedy decoding gives the reference's tokens.  Temperature sampling draws
from a ``torch.Generator`` seeded by ``seed``: it cannot replay JAX's PRNG,
so its tokens are the reference's in distribution only.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model

PyTree = dict


@dataclasses.dataclass
class Request:
    uid: int
    tenant: str
    prompt: np.ndarray             # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0       # 0 => greedy
    # filled by the engine:
    output: Optional[np.ndarray] = None


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pos: int = 0                   # next cache position
    generated: List[int] = dataclasses.field(default_factory=list)
    pending_prompt: int = 0        # prompt tokens not yet consumed

    @property
    def free(self) -> bool:
        return self.request is None


class ServingEngine:
    """``params`` and ``adapters`` live on ``device`` (the CUDA card unless
    the caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, params: PyTree,
                 adapters: Dict[str, PyTree], *, slots: int = 4,
                 cache_len: int = 256, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.model = build_model(cfg, device)
        self.params = params
        self.adapters = dict(adapters)
        self.n_slots = slots
        self.cache_len = cache_len
        self.queues: Dict[str, deque] = defaultdict(deque)
        self.finished: List[Request] = []
        self._gen = torch.Generator().manual_seed(seed)
        self._step = self.model.serve_step
        self.stats = {"decode_steps": 0, "adapter_switches": 0,
                      "completed": 0}

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        if req.tenant not in self.adapters:
            raise KeyError(f"unknown tenant {req.tenant!r}")
        self.queues[req.tenant].append(req)

    def _pick_tenant(self) -> Optional[str]:
        """Longest-backlog-first across tenants (Alg. 2 flavor: serve the
        queue whose downstream work is largest)."""
        pending = {t: len(q) for t, q in self.queues.items() if q}
        if not pending:
            return None
        return max(pending, key=lambda t: (pending[t], t))

    def _sample(self, logits: np.ndarray, temperature: float) -> int:
        if temperature > 0:
            probs = torch.softmax(torch.from_numpy(logits) / temperature, dim=-1)
            return int(torch.multinomial(probs, 1, generator=self._gen))
        return int(np.argmax(logits))

    # ------------------------------------------------------------- execution
    def _run_tenant(self, tenant: str) -> None:
        """Drain (part of) one tenant's queue with batched decode."""
        lora = self.adapters[tenant]
        cache = self.model.init_cache(self.n_slots, self.cache_len)
        slots = [_Slot() for _ in range(self.n_slots)]
        queue = self.queues[tenant]
        self.stats["adapter_switches"] += 1

        def admit():
            changed = False
            for s in slots:
                if s.free and queue:
                    req = queue.popleft()
                    s.request = req
                    s.pos = 0
                    s.generated = []
                    s.pending_prompt = len(req.prompt)
                    changed = True
            return changed

        admit()
        while any(not s.free for s in slots):
            # the token column of this step: prompt replay or the last
            # generated token per slot
            tok = np.zeros((self.n_slots, 1), np.int32)
            for i, s in enumerate(slots):
                if s.free:
                    continue
                req = s.request
                if s.pending_prompt > 0:
                    tok[i, 0] = req.prompt[len(req.prompt) - s.pending_prompt]
                elif s.generated:
                    tok[i, 0] = s.generated[-1]
            # all active slots share the same step index by construction
            # (slots are refilled in lockstep per tenant drain)
            pos = max(s.pos for s in slots if not s.free)
            logits, cache = self._step(
                self.params, lora, cache,
                torch.from_numpy(tok).to(self.model.device), pos)
            self.stats["decode_steps"] += 1
            logits_np = logits[:, -1, :].float().cpu().numpy()

            for i, s in enumerate(slots):
                if s.free:
                    continue
                req = s.request
                s.pos += 1
                if s.pending_prompt > 1:
                    s.pending_prompt -= 1
                    continue
                if s.pending_prompt == 1:
                    s.pending_prompt = 0    # prompt consumed; sample next
                nxt = self._sample(logits_np[i], req.temperature)
                s.generated.append(nxt)
                done = (len(s.generated) >= req.max_new_tokens
                        or (req.eos_id is not None and nxt == req.eos_id)
                        or s.pos >= self.cache_len - 1)
                if done:
                    req.output = np.asarray(s.generated, np.int32)
                    self.finished.append(req)
                    self.stats["completed"] += 1
                    s.request = None
            # only admit new work when the whole batch drained (slot positions
            # must stay aligned because `pos` is shared)
            if all(s.free for s in slots):
                if not admit():
                    break

    def run(self, max_tenant_rounds: int = 100) -> List[Request]:
        """Serve until all queues drain; returns finished requests."""
        for _ in range(max_tenant_rounds):
            tenant = self._pick_tenant()
            if tenant is None:
                break
            self._run_tenant(tenant)
        return self.finished
