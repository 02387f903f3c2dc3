from .mesh import batch_sharding, init_distributed, make_mesh, param_sharding, replicated, shard_params
from .moe import init_moe_params, moe_apply_dense, moe_apply_ep, shard_moe_params
from .pipeline import chunk_blocks, masked_stage_fn, pipeline_apply, shard_stacked_params, stack_stages
from .tiling import TileGrid, TiledProgram, extract_tiles, plan_grid, stitch_tiles, tiled_program, upscale_padded, upscale_tiled

__all__ = [
    'TileGrid',
    'TiledProgram',
    'batch_sharding',
    'chunk_blocks',
    'extract_tiles',
    'init_distributed',
    'init_moe_params',
    'make_mesh',
    'masked_stage_fn',
    'moe_apply_dense',
    'moe_apply_ep',
    'param_sharding',
    'pipeline_apply',
    'plan_grid',
    'replicated',
    'shard_moe_params',
    'shard_params',
    'shard_stacked_params',
    'stack_stages',
    'stitch_tiles',
    'tiled_program',
    'upscale_padded',
    'upscale_tiled',
]
