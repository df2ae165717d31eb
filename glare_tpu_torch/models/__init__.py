"""Model registry (counterpart of ``glare_tpu/models/__init__.py``).

``create_model(opt, device=...)`` maps ``opt['model']`` to a wrapper class.
Only the stage-3 model ('VQLLFLOWD') is ported so far.
"""

from __future__ import annotations


def create_model(opt, step=0, device="cuda"):
    model_name = opt["model"]
    if model_name == "VQLLFLOWD":
        from .vqllflowd_model import VQLLFLOWDModel

        return VQLLFLOWDModel(opt, step, device=device)
    if model_name == "LLFlow":
        raise NotImplementedError(
            "Model [LLFlow] (stage 2) is not ported yet; it comes in a later slice of the port")
    raise NotImplementedError(f"Model [{model_name}] not recognized.")
