from .stats import StatsRecorder

__all__ = ["StatsRecorder"]
