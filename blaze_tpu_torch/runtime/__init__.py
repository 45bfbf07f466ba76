"""Task runtime: the task context and per-operator metrics."""
