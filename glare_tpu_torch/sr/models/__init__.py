"""Model registry with auto-import (reference: basicsr/models/__init__.py)."""

from ..registry import MODEL_REGISTRY, auto_import

auto_import(__name__, "_model")


def build_model(opt, device="cuda"):
    """The conf's ``model_type`` on ``device`` ('cuda' unless the caller asks for
    the CPU; raises without a GPU)."""
    return MODEL_REGISTRY.get(opt["model_type"])(opt, device=device)
