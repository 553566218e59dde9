"""Chaos engineering layer: deterministic fault campaigns, gray
failures, and the adaptive timeout/quarantine response loop."""
from repro_torch.chaos.campaign import ChaosConfig, ChaosEvent, build_campaign
from repro_torch.chaos.inject import ChaosSubsystem, ChaosSummary
from repro_torch.chaos.response import (ResponseConfig, ResponseSubsystem,
                                        ResponseSummary)

__all__ = [
    "ChaosConfig",
    "ChaosEvent",
    "build_campaign",
    "ChaosSubsystem",
    "ChaosSummary",
    "ResponseConfig",
    "ResponseSubsystem",
    "ResponseSummary",
]
