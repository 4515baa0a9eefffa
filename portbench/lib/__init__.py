"""What every cell shares: the specification files, the device trace and
the result line."""
