"""Serving: KV-cache decode steps (models + train.step.make_serve_step)
and JoSS request routing across pods."""
from repro_torch.serve.router import JossServeRouter, Request, RouteDecision

__all__ = ["JossServeRouter", "Request", "RouteDecision"]
