from .timer import TickTock, Timer
from .util import (get_resume_paths, get_timestamp, mkdir, mkdir_and_rename, mkdirs, natsorted,
                   opt_get, set_random_seed, setup_logger)

__all__ = ["natsorted", "opt_get", "get_resume_paths", "get_timestamp", "mkdir", "mkdirs",
           "mkdir_and_rename", "set_random_seed", "setup_logger", "Timer", "TickTock"]
