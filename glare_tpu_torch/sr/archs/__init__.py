"""Architecture registry with auto-import (reference: basicsr/archs/__init__.py)."""

from ..registry import ARCH_REGISTRY, auto_import

auto_import(__name__, "_arch")


def build_network(opt):
    opt = dict(opt)
    network_type = opt.pop("type")
    return ARCH_REGISTRY.get(network_type)(**opt)
