"""img_per_s.f32: see harness/readers.py."""
from benchmark.harness.readers import img_per_s as read  # noqa: F401
