"""Continuous-batching serving engine over :class:`TransformerLM`.

Counterpart of ``neuralnetworklibrary_tpu/serving/engine.py``.  The engine
owns a ``slots``-row KV cache; every decode step runs all slots at their
own positions (per-row ``offsets``), and after each chunk of steps the host
retires finished requests and admits queued ones into the freed slots.

- Prefill runs per request through a batch-1 dense cache at a bucketed
  prompt length, then the filled rows are copied into the slot.  Right
  padding is inert: a causal query never attends positions after its own,
  and a slot's later decode writes overwrite the padded rows before any
  query can reach them.
- Inactive slots recycle their last token; their K/V writes land in rows
  that a future prefill fully replaces (or, paged, in trash row 0).
- Sampling per slot: repetition penalty -> temperature -> top-k ->
  nucleus, each request free to override the engine defaults.  k=1 is
  exact greedy with the first index winning ties (a stable sort), which
  makes greedy emission token-exact with the JAX engine.  Random streams
  come from a ``torch.Generator`` and differ from JAX's by design.

The model's device is the engine's device.  Caches are updated in place.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from neuralnetworklibrary_tpu_torch.nn.transformer import init_cache


class Request:
    """One generation request: ``prompt`` token ids, ``max_new`` tokens to
    emit, an optional ``eos_token``, and per-request overrides of the
    engine's sampling defaults (None keeps the engine's).  Generation also
    stops when the emitted tail equals one of ``stop_sequences`` (kept,
    like EOS).  The engine fills ``tokens``, ``finished`` and the
    ``admitted_at_step`` / ``finished_at_step`` telemetry (in decode
    steps)."""

    def __init__(self, prompt: Sequence[int], max_new: int,
                 eos_token: Optional[int] = None, k: Optional[int] = None,
                 temperature: Optional[float] = None,
                 top_p: Optional[float] = None,
                 repetition_penalty: Optional[float] = None,
                 stop_sequences: Optional[Sequence[Sequence[int]]] = None):
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.max_new = int(max_new)
        self.eos_token = eos_token
        self.k = k
        self.temperature = temperature
        self.top_p = top_p
        self.repetition_penalty = repetition_penalty
        self.stop_sequences = [[int(t) for t in s]
                               for s in (stop_sequences or [])]
        if any(not s for s in self.stop_sequences):
            raise ValueError("empty stop sequence")
        self.tokens: list = []
        self.finished = False
        self.admitted_at_step: Optional[int] = None
        self.finished_at_step: Optional[int] = None


class ServingEngine:
    """Slot-scheduled continuous batching over a dense KV cache.

    model: a TransformerLM (not paged: those go to PagedServingEngine).
    slots: in-flight sequences, the decode batch.
    prompt_buckets: prefill lengths; a prompt pads to the smallest bucket
        that holds it (longer prompts: the next power of two, capped at
        max_len).
    k / temperature / top_p / repetition_penalty: default sampling, which
        every Request may override; max_k bounds k.
    eos_token: default stop token.  pad_token: the (inert) prefill pad id.
    seed: seeds the engine's torch.Generator.
    chunk: decode steps between host looks.  The run loop shortens a chunk
        to the largest power of two within the smallest remaining budget of
        the active slots, so budget retirements fall on chunk boundaries;
        EOS/stop retirements mid-chunk trim the surplus tokens.
    """

    def __init__(self, model, slots: int = 4,
                 prompt_buckets: Sequence[int] = (32, 128, 512),
                 eos_token: Optional[int] = None, k: int = 1,
                 temperature: float = 1.0, top_p: float = 1.0,
                 repetition_penalty: float = 1.0, max_k: int = 64,
                 pad_token: int = 0, seed: int = 0, chunk: int = 1):
        if model.max_len <= 0:
            raise ValueError("model.max_len must be > 0 for decoding")
        if model.paged_kv_blocks > 0 and not hasattr(self, "n_blocks"):
            raise ValueError(
                "paged_kv_blocks > 0 models serve through "
                "serving.paged.PagedServingEngine, not the dense engine")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.model = model
        self.device = model.word_embed.device
        self.slots = int(slots)
        self.eos_token = eos_token
        self.k, self.temperature = int(k), float(temperature)
        self.top_p = float(top_p)
        self.repetition_penalty = float(repetition_penalty)
        self.max_k = min(int(max_k), model.vocab_size)
        self._check_sampling(self.k, self.temperature, self.top_p,
                             self.repetition_penalty)
        self.pad_token = int(pad_token)
        self.chunk = int(chunk)
        # per-slot sampling parameters (host copies, sent with each chunk)
        # and the device-resident seen-token counts of the penalty
        self._k_arr = np.full(self.slots, self.k, np.int64)
        self._t_arr = np.full(self.slots, self.temperature, np.float32)
        self._p_arr = np.full(self.slots, self.top_p, np.float32)
        self._r_arr = np.full(self.slots, self.repetition_penalty,
                              np.float32)
        self._seen = torch.zeros(self.slots, model.vocab_size,
                                 dtype=torch.int32, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.buckets = tuple(sorted(b for b in prompt_buckets
                                    if b <= model.max_len))
        self.cache = init_cache(model, self.slots)
        self.stats = {"decode_steps": 0, "prefills": 0, "prefill_tokens": 0,
                      "slot_steps_active": 0, "slot_steps_total": 0,
                      "sat_slot_steps_active": 0, "sat_slot_steps_total": 0}

    # ------------------------------------------------------------ sampling

    def _check_sampling(self, k, temperature, top_p, rep):
        if not 1 <= int(k) <= self.max_k:
            raise ValueError(f"k must be in [1, max_k={self.max_k}], got {k}")
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        if not 0 < top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if rep <= 0:
            raise ValueError(f"repetition_penalty must be > 0, got {rep}")

    def _sample(self, logits, k, temp, top_p, rep, seen):
        """One token per row under that row's parameters.  logits (S, V);
        k, temp, top_p, rep (S,) tensors; seen (S, V) counts.  Rank 0
        always survives the k and nucleus masks, so k=1 is argmax with the
        first index winning ties."""
        logits = logits.float()
        pen = torch.where(logits > 0, logits / rep[:, None],
                          logits * rep[:, None])
        logits = torch.where(seen > 0, pen, logits)
        logits = logits / temp.clamp_min(1e-6)[:, None]
        vals, idxs = torch.sort(logits, dim=-1, descending=True, stable=True)
        vals, idxs = vals[:, :self.max_k], idxs[:, :self.max_k]
        rank = torch.arange(self.max_k, device=logits.device)[None]
        vals = vals.masked_fill(rank >= k[:, None], float("-inf"))
        probs = torch.softmax(vals, dim=-1)
        vals = vals.masked_fill(probs.cumsum(-1) - probs >= top_p[:, None],
                                float("-inf"))
        choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                   generator=self._gen)
        return idxs.gather(1, choice)[:, 0].to(torch.int32)

    def _slot_params(self, idx=slice(None)):
        dev = self.device
        return (torch.as_tensor(self._k_arr[idx], device=dev),
                torch.as_tensor(self._t_arr[idx], device=dev),
                torch.as_tensor(self._p_arr[idx], device=dev),
                torch.as_tensor(self._r_arr[idx], device=dev))

    # ---------------------------------------------------- prefill, decode

    def _insert_prefill(self, cache1, slot: int):
        """Copy a completed batch-1 prefill cache into ``slot`` (the paged
        engine scatters into the slot's pool rows instead)."""
        for i in range(self.model.n_layers):
            dst = self.cache[f"block_{i}"]["attn"]
            src = cache1[f"block_{i}"]["attn"]
            dst["k"][slot] = src["k"][0]
            dst["v"][slot] = src["v"][0]

    def _decode_kw(self) -> dict:
        """Extra model arguments of every decode step (the paged engine
        sends its block table)."""
        return {}

    def _decode_chunk(self, toks, lengths, active, n_steps: int):
        """``n_steps`` decode steps of every slot, all on the device; the
        host reads the (n_steps, S) tokens once at the end."""
        kv, tv, pv, rv = self._slot_params()
        kw = self._decode_kw()
        step_len = active.to(torch.int32)
        seq = []
        for _ in range(n_steps):
            logits, _ = self.model(toks[:, None], decode=True,
                                   offsets=lengths, cache=self.cache, **kw)
            nxt = self._sample(logits[:, -1], kv, tv, pv, rv, self._seen)
            nxt = torch.where(active, nxt, toks)
            self._seen.scatter_add_(1, nxt[:, None].long(),
                                    step_len[:, None])
            lengths = lengths + step_len
            toks = nxt
            seq.append(nxt)
        return torch.stack(seq).cpu().numpy()

    # ---------------------------------------------------- engine hooks

    def _can_admit(self, req: Request) -> bool:
        """May ``req`` be admitted now?  (The paged engine gates on free
        pool blocks.)"""
        return True

    def _on_retire(self, slot: int):
        """A slot's request just finished (the paged engine frees its
        blocks)."""

    def _pre_decode(self, queue, slot_req, lengths, toks):
        """Runs before every decode chunk (the paged engine allocates the
        blocks the chunk will write, preempting if the pool is dry)."""

    # ------------------------------------------------------ scheduling

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        p = 1
        while p < n:
            p *= 2
        return min(p, self.model.max_len)

    def _admit(self, req: Request, slot: int, lengths, toks):
        p = np.asarray(req.prompt, np.int64)
        if len(p) + 1 > self.model.max_len:
            raise ValueError(
                f"prompt length {len(p)} leaves no room to decode under "
                f"max_len {self.model.max_len}")
        rk = self.k if req.k is None else int(req.k)
        rt = (self.temperature if req.temperature is None
              else float(req.temperature))
        rp = self.top_p if req.top_p is None else float(req.top_p)
        rr = (self.repetition_penalty if req.repetition_penalty is None
              else float(req.repetition_penalty))
        self._check_sampling(rk, rt, rp, rr)
        self._k_arr[slot], self._t_arr[slot] = rk, rt
        self._p_arr[slot], self._r_arr[slot] = rp, rr
        seen_row = torch.as_tensor(
            np.bincount(p, minlength=self.model.vocab_size).astype(np.int32),
            device=self.device)
        tb = self._bucket_for(len(p))
        padded = np.full((1, tb), self.pad_token, np.int64)
        padded[0, :len(p)] = p
        cache1 = init_cache(self.model, 1, paged=False)
        logits, _ = self.model(torch.as_tensor(padded, device=self.device),
                               decode=True, cache=cache1)
        self._insert_prefill(cache1, slot)
        tok = int(self._sample(logits[:, len(p) - 1],
                               *self._slot_params([slot]), seen_row[None]))
        seen_row[tok] += 1
        self._seen[slot] = seen_row
        self.stats["prefill_tokens"] += len(p)
        self.stats["prefills"] += 1
        req.tokens.append(tok)
        req.admitted_at_step = self.stats["decode_steps"]
        lengths[slot] = len(p)
        toks[slot] = tok

    def _finished(self, req: Request, length: int) -> bool:
        eos = req.eos_token if req.eos_token is not None else self.eos_token
        return (len(req.tokens) >= req.max_new
                or (eos is not None and req.tokens[-1] == int(eos))
                or any(req.tokens[-len(s):] == s
                       for s in req.stop_sequences)
                or length + 1 >= self.model.max_len)

    @torch.no_grad()
    def run(self, requests: Sequence[Request], on_token=None):
        """Serve ``requests`` to completion with continuous batching and
        return them with ``tokens`` / ``finished`` / telemetry filled in.
        The engine state (cache, generator, stats) persists across calls.
        ``on_token(request, token_id)`` streams each token as the host sees
        it: at admission for the prefill's token, then per chunk."""
        queue = deque(requests)
        slot_req: list = [None] * self.slots
        lengths = np.zeros(self.slots, np.int32)
        toks = np.zeros(self.slots, np.int32)

        def retire(s):
            req = slot_req[s]
            req.finished = True
            req.finished_at_step = self.stats["decode_steps"]
            slot_req[s] = None
            self._on_retire(s)

        while queue or any(r is not None for r in slot_req):
            for s in range(self.slots):
                if slot_req[s] is None and queue \
                        and self._can_admit(queue[0]):
                    req = queue.popleft()
                    slot_req[s] = req
                    self._admit(req, s, lengths, toks)
                    if on_token is not None:
                        on_token(req, req.tokens[-1])
                    if self._finished(req, int(lengths[s])):
                        retire(s)
            self._pre_decode(queue, slot_req, lengths, toks)
            active = np.array([r is not None for r in slot_req])
            if not active.any():
                continue
            rem = min(min(slot_req[s].max_new - len(slot_req[s].tokens),
                          self.model.max_len - 1 - int(lengths[s]))
                      for s in range(self.slots) if active[s])
            n_steps = 1
            while n_steps * 2 <= min(self.chunk, rem):
                n_steps *= 2
            seq = self._decode_chunk(
                torch.as_tensor(toks, device=self.device),
                torch.as_tensor(lengths, device=self.device),
                torch.as_tensor(active, device=self.device), n_steps)
            saturated = bool(queue)  # work was waiting during this chunk
            self.stats["decode_steps"] += n_steps
            self.stats["slot_steps_total"] += self.slots * n_steps
            if saturated:
                self.stats["sat_slot_steps_total"] += self.slots * n_steps
            for s in range(self.slots):
                req = slot_req[s]
                if req is None:
                    continue
                for t in range(n_steps):
                    lengths[s] += 1
                    toks[s] = int(seq[t, s])
                    req.tokens.append(int(seq[t, s]))
                    if on_token is not None:
                        on_token(req, int(seq[t, s]))
                    self.stats["slot_steps_active"] += 1
                    if saturated:
                        self.stats["sat_slot_steps_active"] += 1
                    if self._finished(req, int(lengths[s])):
                        retire(s)      # surplus chunk tokens are trimmed
                        break
        return list(requests)

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        tot = self.stats["slot_steps_total"]
        return self.stats["slot_steps_active"] / tot if tot else 0.0

    @property
    def occupancy_saturated(self) -> float:
        """Occupancy over the chunks dispatched while requests were waiting
        in the queue (the drain tail of a finite batch cannot lower it)."""
        tot = self.stats["sat_slot_steps_total"]
        return self.stats["sat_slot_steps_active"] / tot if tot else 0.0
