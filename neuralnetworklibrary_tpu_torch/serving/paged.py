"""Paged-KV continuous batching: the vLLM memory model.

Counterpart of ``neuralnetworklibrary_tpu/serving/paged.py``.  K/V live in
one shared pool of fixed-size blocks per layer
(``TransformerLM(paged_kv_blocks=N, paged_kv_block=B)``), and each
in-flight sequence holds only the blocks its tokens occupy:

- a host-side allocator hands out pool rows.  Row 0 is the trash block:
  unallocated table entries point at it, inactive slots write into it, and
  the position mask keeps it out of every softmax;
- each decode chunk sends a (slots, ceil(max_len/block)) int32 block
  table; the model scatters each step's K/V into the pool in place and the
  CUDA kernel reads the slot's blocks straight from it;
- blocks are allocated on demand as sequences cross block boundaries and
  freed when a request retires;
- when the pool runs dry the youngest active request is preempted by
  recompute: its blocks are freed and it re-queues with ``prompt +
  emitted`` as its prompt.  Greedy emission is unchanged, since the causal
  re-prefill reproduces the state.

Prefill runs through a dense batch-1 cache, then :func:`_pool_insert`
scatters the strip into the slot's blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from neuralnetworklibrary_tpu_torch.serving.engine import Request, ServingEngine


def _pool_insert(cache, dense, rows, block: int):
    """Scatter a dense batch-1 cache strip into pool blocks, in place.

    cache: the engine's paged cache; dense: a batch-1 dense cache of the
    same model; rows: (MB,) int64 pool rows of the slot's logical blocks
    (0, the trash row, for unallocated ones — those writes land there).
    """
    mb = rows.shape[0]
    for name, layer in cache.items():
        if name == "idx":
            continue
        pool, strip = layer["attn"], dense[name]["attn"]
        for pn, dn in (("pool_k", "k"), ("pool_v", "v")):
            s = strip[dn][0]                               # (M, Hkv, hd)
            pad = mb * block - s.shape[0]
            if pad > 0:
                s = torch.cat([s, s.new_zeros((pad,) + s.shape[1:])])
            pool[pn][rows] = s[:mb * block].reshape(mb, block, *s.shape[1:])


class PagedServingEngine(ServingEngine):
    """Continuous batching over a paged KV pool.

    model: a TransformerLM with ``paged_kv_blocks`` > ceil(max_len /
    paged_kv_block), so one max-length sequence plus the trash block always
    fits and a lone request can run to completion.  Other arguments as
    :class:`ServingEngine`.  Extra stats: ``preemptions`` (recompute
    evictions) and ``blocks_peak`` (most pool blocks in use, trash block
    excluded).
    """

    def __init__(self, model, slots: int = 4, **kw):
        if model.paged_kv_blocks <= 0:
            raise ValueError(
                "PagedServingEngine needs a model with paged_kv_blocks > 0 "
                "(use the dense ServingEngine otherwise)")
        self.block = int(model.paged_kv_block)
        self.n_blocks = int(model.paged_kv_blocks)
        self.mb = -(-model.max_len // self.block)
        if self.n_blocks < self.mb + 1:
            raise ValueError(
                f"paged_kv_blocks must exceed ceil(max_len/block) = "
                f"{self.mb} (one max-length sequence + the trash block), "
                f"got {self.n_blocks}")
        super().__init__(model, slots=slots, **kw)
        self._table = np.zeros((self.slots, self.mb), np.int32)
        self._free = list(range(self.n_blocks - 1, 0, -1))  # row 0 = trash
        self._owned: list = [[] for _ in range(self.slots)]
        self._slot_seq = np.zeros(self.slots, np.int64)
        self._seq = 0
        self.stats.update(preemptions=0, blocks_peak=0)

    # ------------------------------------------------------- allocator

    def _alloc(self, slot: int, n: int) -> bool:
        """Grow ``slot`` to ``n`` logical blocks; False if the pool is dry."""
        n = min(n, self.mb)
        while len(self._owned[slot]) < n:
            if not self._free:
                return False
            r = self._free.pop()
            self._table[slot, len(self._owned[slot])] = r
            self._owned[slot].append(r)
        used = self.n_blocks - 1 - len(self._free)
        self.stats["blocks_peak"] = max(self.stats["blocks_peak"], used)
        return True

    def _free_slot(self, slot: int):
        self._free.extend(self._owned[slot])
        self._owned[slot].clear()
        self._table[slot, :] = 0

    def _preempt(self, slot: int, queue, slot_req):
        """Recompute-style eviction: free the slot's blocks and re-queue its
        request at the front with ``original prompt + emitted tokens``."""
        req = slot_req[slot]
        if not hasattr(req, "_orig_prompt"):
            req._orig_prompt = list(req.prompt)
        req.prompt = list(req._orig_prompt) + list(req.tokens)
        slot_req[slot] = None
        self._free_slot(slot)
        queue.appendleft(req)
        self.stats["preemptions"] += 1

    # ---------------------------------------------------- engine hooks

    def _decode_kw(self) -> dict:
        return {"block_table": torch.as_tensor(self._table,
                                               device=self.device)}

    def _insert_prefill(self, cache1, slot: int):
        rows = torch.as_tensor(self._table[slot], dtype=torch.int64,
                               device=self.device)
        _pool_insert(self.cache, cache1, rows, self.block)

    def _can_admit(self, req: Request) -> bool:
        need = min(-(-(len(req.prompt) + 1) // self.block), self.mb)
        return len(self._free) >= need

    def _on_retire(self, slot: int):
        self._free_slot(slot)

    def _admit(self, req: Request, slot: int, lengths, toks):
        if not self._alloc(slot, -(-(len(req.prompt) + 1) // self.block)):
            raise RuntimeError("pool exhausted at admission "
                               "(_can_admit should have gated this)")
        self._slot_seq[slot] = self._seq
        self._seq += 1
        super()._admit(req, slot, lengths, toks)

    def _pre_decode(self, queue, slot_req, lengths, toks):
        """Allocate the blocks this chunk will write; preempt youngest-first
        when the pool runs dry (the slot itself only as the last resort)."""
        for s in range(self.slots):
            if slot_req[s] is None:
                continue
            need = -(-(int(lengths[s]) + self.chunk) // self.block)
            while not self._alloc(s, need):
                victims = [t for t in range(self.slots)
                           if t != s and slot_req[t] is not None]
                v = (max(victims, key=lambda t: self._slot_seq[t])
                     if victims else s)
                self._preempt(v, queue, slot_req)
                if v == s:
                    break
