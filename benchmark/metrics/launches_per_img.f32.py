"""launches_per_img.f32: see harness/readers.py."""
from benchmark.harness.readers import launches_per_img as read  # noqa: F401
