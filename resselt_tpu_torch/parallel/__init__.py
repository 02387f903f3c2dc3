from .tiling import TileGrid, TiledProgram, extract_tiles, plan_grid, stitch_tiles, tiled_program, upscale_padded, upscale_tiled

__all__ = [
    'TileGrid',
    'TiledProgram',
    'extract_tiles',
    'plan_grid',
    'stitch_tiles',
    'tiled_program',
    'upscale_padded',
    'upscale_tiled',
]
