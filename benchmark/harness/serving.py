"""What the GLARE serving entries share: the weights that both sides hold, and the
plain reference's answers to the same photos.

An entry passes its own ``reference_inputs(photos, device)`` (the reference's
preprocessing, from the uint8 photos) and ``reference_outputs(y, photos)`` (the
served image cut and typed as the program returns it).
"""

from __future__ import annotations

import sys

from . import weights
from ..reference import glare


def _reference(cfg, state, device):
    ref = glare.Reference(cfg).to(device)
    ref.load_state_dict(state)
    return ref


def prepare(cfg, pool, seed, device, log, reference_inputs):
    """The seeded weights on ``device``; at stage 3 with the offset heads fitted
    by the reference on the pool's first photo (``weights.fit_offset_heads``)."""
    state = weights.make_state(cfg, seed, device)
    if "offset_targets" in cfg:
        x = reference_inputs(pool[:1], device)
        stats = weights.fit_offset_heads(cfg, _reference(cfg, state, device), x, seed, state)
        log(f"offset heads: {stats}", file=sys.stderr)
    return state


def reference(cfg, state, device, precision, reference_inputs, reference_outputs):
    """``(photos) -> answers`` of the reference computed in ``precision``
    (None: float32, TF32 off)."""
    ref = _reference(cfg, state, device)

    def answer(photos):
        return reference_outputs(glare.run(ref, reference_inputs(photos, device), precision), photos)

    return answer
