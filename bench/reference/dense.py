"""Dense decoder-only transformer with grouped-query attention, as the
configuration file states it: pre-norm RMSNorm blocks, rotary positions on
halves of each head, causal softmax attention with H query heads over G
key/value heads (query head h reads key/value head h // (H / G)), a SwiGLU
feed-forward, a final RMSNorm and logits against the embedding (tied) or a
head. Float32 throughout; ``precision`` as in ``bench.reference``.

The weights are a name -> tensor mapping of the layout ``leaves`` gives:
matrices (in, out), the embedding (padded vocabulary, d).
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import (cross_entropy, head_dim, matmul, padded_vocab,
                             rms_norm)

#: queries a block of the plain attention (bounds its (H, q, k) scores)
Q_BLOCK = 1024


def leaves(c: Mapping) -> List[Tuple[str, Tuple[int, ...], str, tuple]]:
    """(name, shape, dtype as served, init) of every weight. Init: ("normal",
    std), or ("const", value)."""
    d, H, G, D, f = (c["d_model"], c["n_heads"], c["n_kv_heads"], head_dim(c),
                     c["d_ff"])
    V = padded_vocab(c)
    one, dt = ("const", 1.0), c["dtype"]
    out = [("embed", (V, d), dt, ("normal", d ** -0.5))]
    for i in range(c["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1.scale", (d,), "float32", one),
                (p + "attn.wq", (d, H * D), dt, ("normal", d ** -0.5)),
                (p + "attn.wk", (d, G * D), dt, ("normal", d ** -0.5)),
                (p + "attn.wv", (d, G * D), dt, ("normal", d ** -0.5)),
                (p + "attn.wo", (H * D, d), dt,
                 ("normal", (H * D) ** -0.5)),
                (p + "ln2.scale", (d,), "float32", one),
                (p + "mlp.wi", (d, 2 * f), dt, ("normal", d ** -0.5)),
                (p + "mlp.wo", (f, d), dt, ("normal", f ** -0.5))]
    out.append(("final_norm.scale", (d,), "float32", one))
    if not c["tie_embeddings"]:
        out.append(("lm_head", (d, V), dt, ("normal", d ** -0.5)))
    return out


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, n, D) rotated by position: the first and second halves of
    each head are the pairs, frequency theta ** (-2 i / D)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                       device=x.device) / D)
    ang = pos.double()[:, None] * inv                    # (S, D/2)
    cos, sin = (t.float()[None, :, None, :] for t in (ang.cos(), ang.sin()))
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal attention of q (B, S, H, D) over k, v (B, S, G, D), in blocks
    of ``Q_BLOCK`` queries."""
    B, S, H, D = q.shape
    G = k.shape[2]
    rep = H // G
    kh = k.repeat_interleave(rep, dim=2).transpose(1, 2)     # (B, H, S, D)
    vh = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    qh = q.transpose(1, 2)
    outs = []
    for lo in range(0, S, Q_BLOCK):
        hi = min(S, lo + Q_BLOCK)
        s = qh[:, :, lo:hi] @ kh[:, :, :hi].transpose(-1, -2) * D ** -0.5
        qi = torch.arange(lo, hi, device=q.device)[:, None]
        ki = torch.arange(hi, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ vh[:, :, :hi])
    return torch.cat(outs, dim=2).transpose(1, 2)


def layer(c: Mapping, P: Mapping[str, torch.Tensor], i: int,
          x: torch.Tensor, precision: str) -> torch.Tensor:
    B, S, d = x.shape
    H, G, D = c["n_heads"], c["n_kv_heads"], head_dim(c)
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    p = f"layers.{i}."
    pos = torch.arange(S, device=x.device)
    h = rms_norm(x, P[p + "ln1.scale"], eps)
    q = rope(matmul(h, P[p + "attn.wq"], precision).view(B, S, H, D), pos,
             theta)
    k = rope(matmul(h, P[p + "attn.wk"], precision).view(B, S, G, D), pos,
             theta)
    v = matmul(h, P[p + "attn.wv"], precision).view(B, S, G, D)
    o = attention(q, k, v).reshape(B, S, H * D)
    x = x + matmul(o, P[p + "attn.wo"], precision)
    h = rms_norm(x, P[p + "ln2.scale"], eps)
    gate, up = matmul(h, P[p + "mlp.wi"], precision).chunk(2, dim=-1)
    return x + matmul(torch.nn.functional.silu(gate) * up, P[p + "mlp.wo"],
                      precision)


def hidden(c: Mapping, P: Mapping[str, torch.Tensor], tokens: torch.Tensor,
           precision: str = "f32", remat: bool = False) -> torch.Tensor:
    """The final-normed states (B, S, d) of tokens (B, S); ``remat``
    recomputes each layer in the backward (for training at full size)."""
    x = P["embed"][tokens.long()]
    for i in range(c["n_layers"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, c, P, i, x, precision, use_reentrant=False)
        else:
            x = layer(c, P, i, x, precision)
    return rms_norm(x, P["final_norm.scale"], c["rms_norm_eps"])


def logits(c: Mapping, P: Mapping[str, torch.Tensor], h: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """Logits over the true vocabulary of final-normed states h."""
    V = c["vocab"]
    head = P["embed"][:V].T if c["tie_embeddings"] else P["lm_head"][:, :V]
    return matmul(h, head, precision)


def loss(c: Mapping, P: Mapping[str, torch.Tensor], tokens: torch.Tensor,
         precision: str = "f32") -> torch.Tensor:
    return cross_entropy(logits(c, P, hidden(c, P, tokens, precision, True),
                                precision), tokens)


@torch.no_grad()
def logits_at(c: Mapping, P: Mapping[str, torch.Tensor], seq: torch.Tensor,
              at: Optional[torch.Tensor] = None, precision: str = "f32"
              ) -> torch.Tensor:
    """One sequence seq (S,): the logits (n, vocab) at positions ``at``
    (every position by default), from one full forward pass."""
    h = hidden(c, P, seq[None], precision)[0]
    return logits(c, P, h if at is None else h[at], precision)

