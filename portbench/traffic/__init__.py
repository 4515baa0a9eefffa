"""Traffic generators, frozen: what a cell feeds the system, made from the
run's seed."""
