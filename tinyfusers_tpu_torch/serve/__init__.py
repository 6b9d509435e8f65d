from .engine import Engine, Request, Result, make_scheduler_core  # noqa: F401
from .router import Router  # noqa: F401
