from .options import NoneDict, dict2str, dict_to_nonedict, parse

__all__ = ["parse", "dict_to_nonedict", "NoneDict", "dict2str"]
