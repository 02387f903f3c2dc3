from .fused_conv import (
    fused_conv3x3_act,
    fused_conv3x3_act_ref,
    fused_conv3x3_pack2,
    fused_conv3x3_pack2_ref,
    fused_conv_lk,
    fused_conv_lk_ref,
    lk_conv_supported,
    pack_conv3x3_weight,
    pack_conv_lk_weight,
)
from .molrcm import fused_molrcm, fused_molrcm_ref, molrcm_supported, pack_molrcm_weights
from .row_gather import row_gather, row_gather_ref
from .window_attention import window_mha, window_mha_ref, window_mha_supported

__all__ = [
    'fused_conv3x3_act',
    'fused_conv3x3_act_ref',
    'fused_conv3x3_pack2',
    'fused_conv3x3_pack2_ref',
    'fused_conv_lk',
    'fused_conv_lk_ref',
    'fused_molrcm',
    'fused_molrcm_ref',
    'lk_conv_supported',
    'molrcm_supported',
    'pack_conv3x3_weight',
    'pack_conv_lk_weight',
    'pack_molrcm_weights',
    'row_gather',
    'row_gather_ref',
    'window_mha',
    'window_mha_ref',
    'window_mha_supported',
]
