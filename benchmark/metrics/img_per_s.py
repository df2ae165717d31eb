"""img_per_s: see harness/readers.py."""
from benchmark.harness.readers import img_per_s as read  # noqa: F401
