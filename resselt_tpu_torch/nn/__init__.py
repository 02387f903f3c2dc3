from . import blocks, functional as F
from .params import PTree

__all__ = ['F', 'PTree', 'blocks']
