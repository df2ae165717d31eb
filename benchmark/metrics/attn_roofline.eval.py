"""attn_roofline.eval: see harness/readers.py."""
from benchmark.harness.readers import attn_roofline as read  # noqa: F401
