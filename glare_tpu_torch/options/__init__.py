from .options import NoneDict, dict_to_nonedict, parse

__all__ = ["parse", "dict_to_nonedict", "NoneDict"]
