"""Point generators, one module per name: ``structure(shape_seed, params)``
fixes a deployment's map (what its configuration file pins), and
``sample(structure, n, seed)`` draws the points within it."""
