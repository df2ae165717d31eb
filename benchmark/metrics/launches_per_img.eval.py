"""launches_per_img.eval: see harness/readers.py."""
from benchmark.harness.readers import launches_per_img as read  # noqa: F401
