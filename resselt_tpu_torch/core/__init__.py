from .factory import Architecture, KeyCondition, ModelMetadata, SRModel, params_from_numpy
from .registry import ArchitectureNotFound, Registry
from .state_dict import canonicalize_state_dict, get_seq_len, remove_common_prefix

__all__ = [
    'Architecture',
    'ArchitectureNotFound',
    'KeyCondition',
    'ModelMetadata',
    'Registry',
    'SRModel',
    'canonicalize_state_dict',
    'get_seq_len',
    'params_from_numpy',
    'remove_common_prefix',
]
