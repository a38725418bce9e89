"""Process-wide runtime services (counters)."""
