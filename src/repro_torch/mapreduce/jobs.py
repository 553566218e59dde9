"""The paper's five benchmarks (§6, PUMA [29][33]) as torch map functions,
the counterpart of ``repro/mapreduce/jobs.py``.

A corpus shard is a pair of int32 tensors (token ids, token byte lengths).
Each map function emits fixed-capacity (key, value, nbytes) tensors:

  WC    - key = token id,             value = 1, bytes = len(word) + 4
  SC    - key = hash(3-gram),         value = 1, bytes = 3-gram bytes + 4
  II    - key = token id,             value = doc id, bytes = len + 4
  Grep  - key = position,             value = 1, only where token == pattern
  Permu - keys = 3 rotations/3-gram,  value = 1, bytes = 3-gram bytes each

The filtering percentage FP (paper Eq. 1-2) is emitted bytes / input bytes.

Keys are the JAX package's uint32 keys held in int64: every product is
taken mod 2^32 (``_mul32``), as uint32 multiplies wrap, and ``EMPTY`` =
0xFFFFFFFF marks an unoccupied slot and sorts after every key, as it does
in uint32; a 3-gram whose hash equals it is dropped, as in JAX.
``word_len`` and ``corpus`` are numpy, copies of JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

#: sentinel for unoccupied kv slots (uint32 max)
EMPTY = 0xFFFFFFFF
MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class KVBatch:
    """Fixed-capacity kv batch; slots with key == EMPTY are invalid."""

    keys: torch.Tensor    # int64 (cap,), values in [0, 2^32)
    values: torch.Tensor  # int32 (cap,)
    nbytes: torch.Tensor  # int32 (cap,) serialized size of each kv pair
    cap: int


@dataclasses.dataclass(frozen=True)
class MapReduceSpec:
    """One benchmark: map fn + capacity multiple + reduce combiner."""

    name: str
    #: map_fn(tokens, lengths, doc_id) -> KVBatch with cap = mult * len(tokens)
    map_fn: Callable[[torch.Tensor, torch.Tensor, int], KVBatch]
    cap_mult: int
    combine_in_map: bool  # run a map-side combiner (affects FP, like Hadoop)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and c < 2^32, without
    int64 overflow: x's 16-bit halves times c stay below 2^48."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _emit(keys, values, nbytes, valid) -> KVBatch:
    keys = torch.where(valid, keys.long() & MASK32, EMPTY)
    zero = torch.zeros((), dtype=torch.int32, device=keys.device)
    values = torch.where(valid, values.int(), zero)
    nbytes = torch.where(valid, nbytes.int(), zero)
    return KVBatch(keys, values, nbytes, keys.shape[0])


def wc_map(tokens, lengths, doc_id) -> KVBatch:
    valid = tokens >= 0
    return _emit(tokens, torch.ones_like(tokens), lengths + 4, valid)


def _gram3(tokens):
    """Hash of each 3 consecutive tokens (positions 0..n-3), and where it
    is valid."""
    a = tokens
    b = torch.roll(tokens, -1)
    c = torch.roll(tokens, -2)
    h = (_mul32(a.long() & MASK32, 2654435761)
         ^ _mul32(b.long() & MASK32, 40503)
         ^ _mul32(c.long() & MASK32, 69427))
    n = tokens.shape[0]
    ok = ((torch.arange(n, device=tokens.device) < n - 2) & (a >= 0)
          & (b >= 0) & (c >= 0))
    return h, ok


def sc_map(tokens, lengths, doc_id) -> KVBatch:
    h, ok = _gram3(tokens)
    size = lengths + torch.roll(lengths, -1) + torch.roll(lengths, -2) + 4
    return _emit(h, torch.ones_like(tokens), size, ok)


def ii_map(tokens, lengths, doc_id) -> KVBatch:
    valid = tokens >= 0
    return _emit(tokens, torch.full_like(tokens, doc_id), lengths + 4, valid)


def grep_map_factory(pattern_id: int):
    def grep_map(tokens, lengths, doc_id) -> KVBatch:
        valid = tokens == pattern_id
        pos = torch.arange(tokens.shape[0], device=tokens.device)
        return _emit(pos, torch.ones_like(tokens), lengths + 4, valid)
    return grep_map


def permu_map(tokens, lengths, doc_id) -> KVBatch:
    """3 rotations of each 3-gram; each record costs one sequence unit, so
    emitted bytes ~ 3x input -> FP ~ 3 (paper Table 5)."""
    h, ok = _gram3(tokens)
    rots = [h ^ ((r * 0x9E3779B9) & MASK32) for r in (0, 1, 2)]
    ones = torch.ones_like(tokens)
    return _emit(torch.cat(rots), torch.cat([ones] * 3),
                 torch.cat([lengths] * 3), torch.cat([ok] * 3))


#: content token ids start here; ids below are web markup ('<page>', ...)
MARKUP_IDS = 64

JOBS: Dict[str, MapReduceSpec] = {
    # PUMA's WC / II emit one record per occurrence (no combiner): FP ~ 1.0+
    "WC": MapReduceSpec("WC", wc_map, 1, combine_in_map=False),
    # SC combines duplicate 3-grams map-side: web boilerplate -> FP < 1
    "SC": MapReduceSpec("SC", sc_map, 1, combine_in_map=True),
    "II": MapReduceSpec("II", ii_map, 1, combine_in_map=False),
    # default pattern: a fairly common content word
    "Grep": MapReduceSpec("Grep", grep_map_factory(MARKUP_IDS + 2), 1,
                          combine_in_map=False),
    "Permu": MapReduceSpec("Permu", permu_map, 3, combine_in_map=False),
}


def word_len(token_ids: np.ndarray) -> np.ndarray:
    """Deterministic byte length per token id (a word has one spelling).

    Markup ids are long (paper Table 2: avg 22, '<format>text/x-wiki</format>'
    etc.); content ids follow a short-word distribution (Table 4: avg ~7.8).
    """
    t = token_ids.astype(np.uint64)
    h = (t * np.uint64(2654435761)) % np.uint64(1 << 32)
    markup = 12 + (h % np.uint64(22))          # 12..33, mean ~22.5
    content = 2 + (h % np.uint64(12))          # 2..13, mean ~7.5
    return np.where(token_ids < MARKUP_IDS, markup, content).astype(np.int32)


# ---------------------------------------------------------------- corpora --
def corpus(kind: str, n_tokens: int, seed: int = 0, vocab: int = 4096
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic corpora mirroring the paper's two input types (Tables 1-4).

    web:     boilerplate markup runs (8 templates over ids < MARKUP_IDS)
             interleaved with Zipf content words -> long avg word length,
             highly repetitive 3-grams (Table 1: '<contributor>' x6294).
    non-web: plain Zipf content words, short lengths (Tables 3-4).
    """
    rng = np.random.RandomState(seed)
    content_span = max(2, vocab - MARKUP_IDS)
    if kind == "web":
        templates = [rng.randint(0, MARKUP_IDS, size=rng.randint(6, 13))
                     for _ in range(8)]
        out: list = []
        while len(out) < n_tokens:
            if rng.rand() < 0.55:
                out.extend(templates[rng.randint(len(templates))])
            else:
                z = int(rng.zipf(1.3)) % content_span
                out.append(MARKUP_IDS + z)
        tokens = np.asarray(out[:n_tokens], dtype=np.int32)
    elif kind == "non-web":
        z = rng.zipf(1.3, size=n_tokens).astype(np.int64) % content_span
        tokens = (MARKUP_IDS + z).astype(np.int32)
    else:
        raise ValueError(f"unknown corpus kind {kind!r}")
    return tokens, word_len(tokens)
