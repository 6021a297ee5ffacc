from .device import resolve_device
from .log import get_logger
from .timer import StageTimer
