"""latency_p95_ms: see harness/readers.py."""
from benchmark.harness.readers import latency_p95_ms as read  # noqa: F401
