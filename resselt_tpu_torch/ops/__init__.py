from .fused_conv import (
    fused_conv3x3_act,
    fused_conv3x3_act_ref,
    fused_conv3x3_pack2,
    fused_conv3x3_pack2_ref,
    pack_conv3x3_weight,
)

__all__ = [
    'fused_conv3x3_act',
    'fused_conv3x3_act_ref',
    'fused_conv3x3_pack2',
    'fused_conv3x3_pack2_ref',
    'pack_conv3x3_weight',
]
