from .logger import AvgTimer, MessageLogger, get_env_info
from .misc import check_resume, get_time_str, make_exp_dirs, scandir, sizeof_fmt
from .options import parse_options

__all__ = [
    "AvgTimer",
    "MessageLogger",
    "check_resume",
    "get_env_info",
    "get_time_str",
    "make_exp_dirs",
    "parse_options",
    "scandir",
    "sizeof_fmt",
]
