"""conv_ms_per_img.eval: see harness/readers.py."""
from benchmark.harness.readers import conv_ms_per_img as read  # noqa: F401
