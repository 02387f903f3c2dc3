"""One module a kind of image size, named as the kind in a mix's
``sizes``: ``arrivals(spec, distinct, rng)`` returns the (height, width)
of each of the mix's distinct images, in the order the requests take them.
Every seed gets the same sizes; ``rng`` (drawn from the seed) may only
order them, where the order does not change the work."""
