"""Deterministic synthetic LM data (port of ``repro.data.pipeline``).

``SyntheticLMConfig`` and ``SyntheticLM`` are the JAX module's, verbatim
(numpy only): batch ``step`` is a pure function of ``(seed, step, row)``,
so a restart regenerates exactly the batches it lost, and rows are
Markov-chain token streams (a fixed random transition table seeded by
``seed``) with document breaks, so a training run shows a falling loss.

:func:`make_batch` builds one step's whole batch on one device;
:func:`make_global_batch` builds it as DTensors on a device mesh, each
rank generating only the rows its block covers (the JAX module's
``make_global_batch``). Tokens and the multimodal stub's ``extra_embeds``
(deterministic low-rank features of the row id: VLM patch or audio-frame
embeddings) equal the JAX batch's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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


def _embeds(cfg: SyntheticLMConfig, idx, t, d) -> np.ndarray:
    """The multimodal stub's features at row ids ``idx``, token ``t`` and
    feature ``d`` (broadcast index arrays)."""
    return np.sin(0.1 * (idx * 131 + t * 17 + d) + cfg.seed
                  ).astype(np.float32)


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
        out["extra_embeds"] = torch.from_numpy(
            _embeds(cfg, idx, t, d)).to(device)
    return out


def make_global_batch(gen: SyntheticLM, step: int, mesh, spec,
                      extra_embed_dim: Optional[int] = None,
                      extra_tokens: int = 0) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch as DTensors on ``mesh`` laid out by ``spec``
    (``launch.sharding.tokens_spec``): each rank generates only the rows
    (and the columns) its block covers. The ``extra_embeds`` follow
    ``spec`` where it has three entries, else its batch entry alone."""
    from repro_torch.launch import sharding as shd
    cfg = gen.cfg
    n_q = max(1, cfg.n_codebooks)
    shape: Tuple[int, ...] = (cfg.global_batch, cfg.seq)
    if n_q > 1:
        shape = shape + (n_q,)
    coord = mesh.get_coordinate()
    device = shd.mesh_device(mesh)
    sl = shd.local_slices(shape, spec, mesh, coord)
    rows = range(sl[0].start, sl[0].stop)
    block = np.stack([gen.row(step, i) for i in rows]) if len(rows) else \
        np.zeros((0,) + shape[1:], np.int32)
    local = torch.from_numpy(np.ascontiguousarray(
        block[(slice(None),) + sl[1:]])).to(device)
    tokens = shd.from_blocks(local, shape, spec, mesh)
    out = {"tokens": tokens, "labels": tokens}
    if extra_embed_dim:
        eshape = (cfg.global_batch, extra_tokens, extra_embed_dim)
        espec = spec if len(spec) == 3 else shd.P(spec[0], None, None)
        el = shd.local_slices(eshape, espec, mesh, coord)
        idx = np.arange(eshape[0])[el[0]].reshape(-1, 1, 1)
        t = np.arange(eshape[1])[el[1]].reshape(1, -1, 1)
        d = np.arange(eshape[2])[el[2]].reshape(1, 1, -1)
        out["extra_embeds"] = shd.from_blocks(
            torch.from_numpy(_embeds(cfg, idx, t, d)).to(device), eshape,
            espec, mesh)
    return out
