"""The CLI on a folder (``upscale.py``'s ``run_plane`` with ``--tile auto``,
no ``--bucket``): an image with a side over the tile runs tiled, on a CUDA
graph where another image of the folder has its size, on the host loop
(``on_device=False``) where none has; a smaller one runs whole.  No library
function gives this rule, so it is copied here."""

from collections import Counter


def _shared(folder) -> set:
    return {size for size, n in Counter(img.shape[:2] for img in folder).items() if n > 1}


def _on_graph(img, tile, shared) -> bool | None:
    """True on a graph, False on the host loop, None whole."""
    if img.shape[0] > tile or img.shape[1] > tile:
        return img.shape[:2] in shared
    return None


def server(model, dtype, tile, folder):
    from resselt_tpu_torch import upscale_tiled

    shared = _shared(folder)

    def serve(img):
        graph = _on_graph(img, tile, shared)
        if graph is None:
            return model(img, dtype=dtype)
        return upscale_tiled(model, img, tile=tile, dtype=dtype, on_device=None if graph else False)

    return serve


def program(model, img, dtype, tile, folder):
    from resselt_tpu_torch.parallel.tiling import tiled_program

    if not _on_graph(img, tile, _shared(folder)):
        return None
    return tiled_program(model, img.shape[0], img.shape[1], tile=tile, dtype=dtype)[0]
