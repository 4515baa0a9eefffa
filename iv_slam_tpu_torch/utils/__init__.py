"""Host utilities: per-stage timers, argument packing (one host-to-device
copy a call) and the host<->device link probe."""
