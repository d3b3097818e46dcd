"""Deterministic synthetic LM data (port of ``repro.data.pipeline``).

``SyntheticLMConfig`` and ``SyntheticLM`` are the JAX module's, verbatim
(numpy only): batch ``step`` is a pure function of ``(seed, step, row)``,
so a restart regenerates exactly the batches it lost, and rows are
Markov-chain token streams (a fixed random transition table seeded by
``seed``) with document breaks, so a training run shows a falling loss.

:func:`make_batch` builds one step's whole batch on one device, in place of
the JAX module's host-sharded ``make_global_batch``, whose sharding comes
with the multi-device port (ROADMAP A15). Its tokens and the multimodal
stub's ``extra_embeds`` (deterministic low-rank features of the row id:
VLM patch or audio-frame embeddings) equal the JAX batch's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    branching: int = 4          # Markov out-degree (lower = more learnable)
    doc_len: int = 1024         # average synthetic document length
    n_codebooks: int = 1        # musicgen-style multi-stream tokens
    pad_id: int = -100          # label id carrying no loss


class SyntheticLM:
    """Deterministic Markov-chain token stream."""

    def __init__(self, cfg: SyntheticLMConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab, 32768)   # cap table size for huge vocabs
        self._v = v
        # per-state successor table: (v, branching)
        self._table = rng.integers(0, v, (v, cfg.branching), dtype=np.int64)

    # -- row generation ------------------------------------------------------
    def _row_rng(self, step: int, row: int) -> np.random.Generator:
        # stable address: independent of host count / sharding
        return np.random.default_rng(
            (self.cfg.seed * 0x9E3779B9 + step * 1_000_003 + row) % (2**63))

    def row(self, step: int, row: int) -> np.ndarray:
        """One (seq,) [or (seq, n_codebooks)] int32 token row."""
        cfg = self.cfg
        rng = self._row_rng(step, row)
        n_q = max(1, cfg.n_codebooks)
        out = np.empty((cfg.seq, n_q), np.int32)
        for q in range(n_q):
            state = int(rng.integers(0, self._v))
            choices = rng.integers(0, cfg.branching, cfg.seq)
            breaks = rng.random(cfg.seq) < (1.0 / cfg.doc_len)
            toks = np.empty((cfg.seq,), np.int64)
            for t in range(cfg.seq):
                if breaks[t]:
                    state = int(rng.integers(0, self._v))
                toks[t] = state
                state = int(self._table[state, choices[t]])
            out[:, q] = toks.astype(np.int32)
        return out if n_q > 1 else out[:, 0]

    def host_batch(self, step: int, rows: range) -> Dict[str, np.ndarray]:
        """The given global-row range (this host's shard) for ``step``."""
        toks = np.stack([self.row(step, r) for r in rows])
        return {"tokens": toks, "labels": toks.copy()}


def make_batch(gen: SyntheticLM, step: int, device="cpu",
               extra_embed_dim: Optional[int] = None,
               extra_tokens: int = 0) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch on ``device``: ``tokens`` (B, T) [or (B, T,
    n_q)] int32, ``labels`` (the same tensor) and, with
    ``extra_embed_dim``, ``extra_embeds`` (B, extra_tokens, dim) fp32."""
    cfg = gen.cfg
    rows = gen.host_batch(step, range(cfg.global_batch))["tokens"]
    tokens = torch.from_numpy(rows).to(device)
    out = {"tokens": tokens, "labels": tokens}
    if extra_embed_dim:
        # multimodal stub: deterministic low-rank features of the row id
        idx = np.arange(cfg.global_batch).reshape(-1, 1, 1)
        t = np.arange(extra_tokens).reshape(1, -1, 1)
        d = np.arange(extra_embed_dim).reshape(1, 1, -1)
        val = np.sin(0.1 * (idx * 131 + t * 17 + d) + cfg.seed)
        out["extra_embeds"] = torch.from_numpy(
            val.astype(np.float32)).to(device)
    return out
