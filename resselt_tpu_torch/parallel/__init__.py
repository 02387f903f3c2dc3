from .tiling import TileGrid, extract_tiles, plan_grid, stitch_tiles, upscale_padded, upscale_tiled

__all__ = [
    'TileGrid',
    'extract_tiles',
    'plan_grid',
    'stitch_tiles',
    'upscale_padded',
    'upscale_tiled',
]
