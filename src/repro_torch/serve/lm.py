"""Serving flow: batched prefill + greedy decode, fronted by the JoSS
request router (policy A for fresh sessions, cache affinity for
follow-ups). The port of ``examples/serve_lm.py``. The model's cache is
whatever its family keeps: a ring KV cache (dense, moe, vlm), an O(1) GLA
state (rwkv6), a sliding-window ring plus the SSM state (hymba), or a ring
plus the cross-attention K/V of the encoder states (encdec). Encdec's
audio frames and vlm's patches are seeded stand-ins for the stubbed
frontends, shaped as the JAX package's ``input_specs``.

Run:  PYTHONPATH=src python -m repro_torch.serve.lm [--requests 8]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.topology import VirtualCluster
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model, prefix_len, side_inputs
from repro_torch.serve.router import JossServeRouter, Request, RouteDecision
from repro_torch.train import make_prefill_step, make_serve_step


@dataclasses.dataclass
class ServeResult:
    decisions: List[RouteDecision]
    cache_hit_rate: float
    load_imbalance: float
    tokens: torch.Tensor          # (B, G) int32 greedy tokens
    logits: torch.Tensor          # (B, G-1, V) logits of the decode steps
    prefill_s: float
    decode_s: float

    @property
    def decode_tok_s(self) -> float:
        """Tokens the G-1 timed decode steps produced, per second (the
        first token comes from prefill and is not counted here)."""
        B, G = self.tokens.shape
        return B * (G - 1) / max(self.decode_s, 1e-9)


def route_requests(n_requests: int, prompt_len: int,
                   gen_len: int) -> JossServeRouter:
    """Route the batch across the pods of ``VirtualCluster([4, 4])``, with
    half of the sessions recurring (control plane)."""
    router = JossServeRouter(VirtualCluster([4, 4]))
    n_sessions = max(1, n_requests // 2)
    for r in range(n_requests):
        router.route(Request(f"req{r}", session=f"sess{r % n_sessions}",
                             prompt_tokens=prompt_len,
                             decode_tokens=gen_len))
    return router


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def serve(cfg: ArchConfig, n_requests: int, prompt_len: int, gen_len: int,
          *, device: DeviceLike = None, seed: int = 0,
          params: Optional[Dict[str, torch.Tensor]] = None,
          prompts: Optional[np.ndarray] = None,
          n_frames: Optional[int] = None,
          inputs: Optional[Dict[str, np.ndarray]] = None) -> ServeResult:
    """Route ``n_requests`` requests, prefill their prompts with
    ``cache_len = V + P + G`` (rwkv6 ignores it; hymba's ring keeps at
    most its window) and run G-1 greedy decode steps at positions V + P +
    i. V is vlm's patch prefix (``vis_tokens``), 0 for the other families.

    ``params`` is a state dict (e.g. from ``convert.params_from_jax``);
    without it the weights are drawn on the device from a generator seeded
    with ``seed``. ``prompts`` (B, P) defaults to
    ``RandomState(seed).randint(0, vocab)``. ``inputs`` holds encdec's
    ``frames`` or vlm's ``patches``; they default to
    ``models.side_inputs`` from ``seed + 1`` (encdec: ``n_frames`` frames,
    P by default, as JAX's ``input_specs`` give a prefill cell S frames).
    """
    dev = resolve_device(device)
    B, P, G = n_requests, prompt_len, gen_len
    router = route_requests(B, P, G)

    model = build_model(cfg, device=dev)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model.init_params(gen)
    else:
        model.load_state_dict(params, strict=True)
    if prompts is None:
        prompts = np.random.RandomState(seed).randint(0, cfg.vocab, (B, P))
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                             device=dev)
    if inputs is None:
        inputs = side_inputs(cfg, B, seed=seed + 1, n_frames=n_frames or P)
    batch = {"tokens": tokens}
    batch.update({name: torch.as_tensor(x, device=dev).to(cfg.tdtype)
                  for name, x in inputs.items()})
    offset = prefix_len(cfg)
    prefill = make_prefill_step(model, cache_len=offset + P + G)
    decode = make_serve_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    next_tok, cache = prefill(batch)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [next_tok]
    step_logits = []
    t0 = time.perf_counter()
    for i in range(G - 1):
        next_tok, logits, cache = decode(cache, out[-1], offset + P + i)
        out.append(next_tok)
        step_logits.append(logits)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    V = cfg.padded_vocab
    logits = (torch.cat(step_logits, dim=1) if step_logits
              else torch.empty((B, 0, V), device=dev))
    return ServeResult(decisions=list(router.decisions),
                       cache_hit_rate=router.cache_hit_rate(),
                       load_imbalance=router.load_imbalance(),
                       tokens=torch.cat(out, dim=1), logits=logits,
                       prefill_s=prefill_s, decode_s=decode_s)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--frames", type=int, default=None,
                    help="encdec: audio frames a request (default: the "
                         "prompt length)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke()
    B, P, G = args.requests, args.prompt_len, args.gen_len
    res = serve(cfg, B, P, G, n_frames=args.frames)
    for d in res.decisions:
        print(f"route {d.rid}: pod {d.pod} (policy {d.policy}, "
              f"cache_hit={d.cache_hit})")
    print(f"router cache-hit rate: {res.cache_hit_rate:.2f}, "
          f"load imbalance: {res.load_imbalance:.2f}")
    print(f"prefill: {B}x{P} tokens in {res.prefill_s:.2f}s | "
          f"decode: {G} steps in {res.decode_s:.2f}s "
          f"({res.decode_tok_s:.1f} tok/s)")
    print("sample generation (request 0):", res.tokens[0, :16].cpu().numpy())


if __name__ == "__main__":
    main()
