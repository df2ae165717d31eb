"""idle_share.photo: see harness/readers.py."""
from benchmark.harness.readers import idle_share as read  # noqa: F401
