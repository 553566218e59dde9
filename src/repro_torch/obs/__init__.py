"""Observability layer: metric registry, structured trace export
and the scoreboard facade for control loops. See ``docs/ARCHITECTURE.md``
("Observability") for the contract — in one line: telemetry owns no
event kinds, consumes no RNG and never touches the heap, so attaching
it is trajectory-invariant."""
from repro_torch.obs.registry import Counter, Gauge, MetricRegistry, WindowSeries
from repro_torch.obs.scoreboard import Scoreboard
from repro_torch.obs.telemetry import TelemetryConfig, TelemetrySubsystem
from repro_torch.obs.trace import TraceExporter

__all__ = [
    "Counter", "Gauge", "MetricRegistry", "WindowSeries",
    "Scoreboard", "TelemetryConfig", "TelemetrySubsystem",
    "TraceExporter",
]
