from .misc import Bunch, clip, logger, progress  # noqa: F401
