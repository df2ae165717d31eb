"""dcn_roofline.eval: see harness/readers.py."""
from benchmark.harness.readers import dcn_roofline as read  # noqa: F401
