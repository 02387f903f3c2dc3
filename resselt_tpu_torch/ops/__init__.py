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
from .window_attention import window_mha, window_mha_ref, window_mha_supported

__all__ = [
    'fused_conv3x3_act',
    'fused_conv3x3_act_ref',
    'fused_conv3x3_pack2',
    'fused_conv3x3_pack2_ref',
    'fused_conv_lk',
    'fused_conv_lk_ref',
    'lk_conv_supported',
    'pack_conv3x3_weight',
    'pack_conv_lk_weight',
    'window_mha',
    'window_mha_ref',
    'window_mha_supported',
]
