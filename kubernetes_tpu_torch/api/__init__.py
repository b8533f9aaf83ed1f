from .quantity import Quantity, parse_quantity  # noqa: F401
from . import types  # noqa: F401
