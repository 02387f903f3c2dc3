"""One module a serving path, named as a mix's ``path``: how the program's
users call it on one image.  Each has

``server(model, dtype, tile, folder)``
    the call, ``serve(image) -> output tensor on the card``; ``folder``
    holds the mix's distinct images, for a path whose rule looks at the
    whole collection (the CLI's);
``program(model, image, dtype, tile, folder)``
    the ``TiledProgram`` whose CUDA graph serves ``image``, or None where
    the image runs eagerly.
"""
