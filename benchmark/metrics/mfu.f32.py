"""mfu.f32: see harness/readers.py."""
from benchmark.harness.readers import mfu as read  # noqa: F401
