from . import functional as F
from .params import PTree

__all__ = ['F', 'PTree']
