"""Where a traffic mix's queries fall, one module per ``"center"`` kind.

A module has ``make(spec, points, config)``, which returns
``draw(rng, q)``: ``q`` centres, a (q, d) array, drawn from ``rng``.
``spec`` is the traffic file, ``points`` the run's points and ``config``
the deployment's configuration."""
