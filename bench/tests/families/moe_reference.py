"""A plain reference of the program's ``moe`` family (no dense residual),
for the tests that add a family as files: the dense reference's blocks with
the SwiGLU feed-forward replaced by ``n_experts`` experts, each token sent
to the ``moe_topk`` of highest softmax router probability, their gates
renormalised over the k; no capacity, so no pair is dropped. Float32;
``precision`` as in ``bench.reference`` (the router's product stays
float32)."""
from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import torch

from bench.reference import dense, head_dim, matmul, rms_norm


def leaves(c: Mapping) -> List[Tuple[str, Tuple[int, ...], str, tuple]]:
    """The dense layout with each layer's ``mlp`` replaced by ``moe``:
    router (d, E) in float32, wi (E, d, 2 f), wo (E, f, d)."""
    d, f, E = c["d_model"], c["d_ff"], c["n_experts"]
    out = []
    for name, shape, dt, init in dense.leaves(c):
        if name.endswith(".mlp.wi"):
            p = name[:-len("mlp.wi")] + "moe."
            out += [(p + "router", (d, E), "float32", ("normal", d ** -0.5)),
                    (p + "wi", (E, d, 2 * f), dt, ("normal", d ** -0.5)),
                    (p + "wo", (E, f, d), dt, ("normal", f ** -0.5))]
        elif not name.endswith(".mlp.wo"):
            out.append((name, shape, dt, init))
    return out


def experts(c: Mapping, P: Mapping[str, torch.Tensor], p: str,
            h: torch.Tensor, precision: str) -> torch.Tensor:
    B, S, d = h.shape
    x = h.reshape(B * S, d)
    probs = torch.softmax(x @ P[p + "router"], dim=-1)
    top, pick = probs.topk(c["moe_topk"], dim=-1)
    gates = top / top.sum(-1, keepdim=True)
    wi, wo = P[p + "wi"], P[p + "wo"]
    out = torch.zeros_like(x)
    for e in range(c["n_experts"]):
        tok, slot = (pick == e).nonzero(as_tuple=True)
        gate, up = matmul(x[tok], wi[e], precision).chunk(2, dim=-1)
        y = matmul(torch.nn.functional.silu(gate) * up, wo[e], precision)
        out.index_add_(0, tok, y * gates[tok, slot, None])
    return out.view(B, S, d)


def layer(c: Mapping, P: Mapping[str, torch.Tensor], i: int,
          x: torch.Tensor, precision: str) -> torch.Tensor:
    B, S, d = x.shape
    H, G, D = c["n_heads"], c["n_kv_heads"], head_dim(c)
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    p = f"layers.{i}."
    pos = torch.arange(S, device=x.device)
    h = rms_norm(x, P[p + "ln1.scale"], eps)
    q = dense.rope(matmul(h, P[p + "attn.wq"], precision).view(B, S, H, D),
                   pos, theta)
    k = dense.rope(matmul(h, P[p + "attn.wk"], precision).view(B, S, G, D),
                   pos, theta)
    v = matmul(h, P[p + "attn.wv"], precision).view(B, S, G, D)
    o = dense.attention(q, k, v).reshape(B, S, H * D)
    x = x + matmul(o, P[p + "attn.wo"], precision)
    h = rms_norm(x, P[p + "ln2.scale"], eps)
    return x + experts(c, P, p + "moe.", h, precision)


def hidden(c: Mapping, P: Mapping[str, torch.Tensor], tokens: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    x = P["embed"][tokens.long()]
    for i in range(c["n_layers"]):
        x = layer(c, P, i, x, precision)
    return rms_norm(x, P["final_norm.scale"], c["rms_norm_eps"])


logits = dense.logits


@torch.no_grad()
def logits_at(c: Mapping, P: Mapping[str, torch.Tensor], seq: torch.Tensor,
              at: Optional[torch.Tensor] = None, precision: str = "f32"
              ) -> torch.Tensor:
    h = hidden(c, P, seq[None], precision)[0]
    return logits(c, P, h if at is None else h[at], precision)
