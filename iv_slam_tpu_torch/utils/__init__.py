"""Host utilities: per-stage timers."""
