from .timer import ScopeTimer, TickTock, Timer
from .util import (copy_tree_once, get_resume_paths, get_timestamp, mkdir, mkdir_and_rename, mkdirs, natsorted,
                   opt_get, set_random_seed, setup_logger)

__all__ = ["copy_tree_once", "natsorted", "opt_get", "get_resume_paths", "get_timestamp", "mkdir", "mkdirs",
           "mkdir_and_rename", "set_random_seed", "setup_logger", "Timer", "TickTock", "ScopeTimer"]
