"""General utilities (the port's own copy of what inference needs from
``glare_tpu/utils/util.py``): option probing and natural sort."""

from __future__ import annotations

import re


def opt_get(opt, keys, default=None):
    """Nested-key probe: ``opt_get(opt, ['network_G', 'flow', 'K'], 12)``."""
    if opt is None:
        return default
    ret = opt
    for k in keys:
        ret = ret.get(k, None) if hasattr(ret, "get") else None
        if ret is None:
            return default
    return ret


_NAT_SPLIT = re.compile(r"(\d+)")


def natsorted(items, key=None):
    """Natural sort (stands in for the natsort package of the reference CLIs)."""

    def natkey(s):
        s = key(s) if key is not None else s
        return [int(t) if t.isdigit() else t.lower() for t in _NAT_SPLIT.split(str(s))]

    return sorted(items, key=natkey)
