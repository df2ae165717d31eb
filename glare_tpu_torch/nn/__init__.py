from .layers import (
    AttnBlock,
    Conv,
    Downsample,
    GroupNorm32,
    ResnetBlock,
    Upsample,
    cast_convs_,
    seed_init_,
    swish,
)

__all__ = ["AttnBlock", "Conv", "Downsample", "GroupNorm32", "ResnetBlock", "Upsample",
           "cast_convs_", "seed_init_", "swish"]
