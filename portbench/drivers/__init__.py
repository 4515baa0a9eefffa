"""Traffic loops, one a driver; a workload file names its driver."""
