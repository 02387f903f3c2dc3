"""``upscale_tiled(model, image, dtype=...)`` at the loader's hints: one
CUDA graph a size, captured at the size's first image."""


def server(model, dtype, tile, folder):
    from resselt_tpu_torch import upscale_tiled

    return lambda img: upscale_tiled(model, img, dtype=dtype)


def program(model, img, dtype, tile, folder):
    from resselt_tpu_torch.parallel.tiling import tiled_program

    return tiled_program(model, img.shape[0], img.shape[1], dtype=dtype)[0]
