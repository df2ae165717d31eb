from .options import NoneDict, check_resume, dict2str, dict_to_nonedict, parse, save_opt

__all__ = ["parse", "dict_to_nonedict", "NoneDict", "dict2str", "check_resume", "save_opt"]
