"""Device placement: the single-card ComputeContext and factor staging."""
