"""The port's training runtime: profiler and the transient-aware trainer."""
