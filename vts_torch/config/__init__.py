from .options import TestOptions

__all__ = ["TestOptions"]
