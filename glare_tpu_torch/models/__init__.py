"""Model registry (counterpart of ``glare_tpu/models/__init__.py``).

``create_model(opt, device=...)`` maps ``opt['model']`` to a wrapper class.
Ported so far: the stage-2 model ('LLFlow') and the stage-3 model
('VQLLFLOWD'), inference and training.
"""

from __future__ import annotations


def create_model(opt, step=0, device="cuda"):
    model_name = opt["model"]
    if model_name == "VQLLFLOWD":
        from .vqllflowd_model import VQLLFLOWDModel

        return VQLLFLOWDModel(opt, step, device=device)
    if model_name == "LLFlow":
        from .llflow_model import LLFlowModel

        return LLFlowModel(opt, step, device=device)
    raise NotImplementedError(f"Model [{model_name}] not recognized.")
