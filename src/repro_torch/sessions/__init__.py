"""Session workloads, twin of `repro.sessions` (the warmth tracker only;
the DAG generator and the session simulator are `ROADMAP.md` queue 1,
item 8)."""
from repro_torch.sessions.warmth import WarmthTracker

__all__ = ["WarmthTracker"]
