"""Option parsing for the port."""

from .options import TestOptions, TrainOptions  # noqa: F401
