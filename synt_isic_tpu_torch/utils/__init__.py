from .config import CLASS_NAMES, NUM_CLASSES
from .logging import Logger
from .paths import PathManager

__all__ = ["CLASS_NAMES", "NUM_CLASSES", "Logger", "PathManager"]
