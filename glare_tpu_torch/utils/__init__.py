from .util import natsorted, opt_get

__all__ = ["natsorted", "opt_get"]
