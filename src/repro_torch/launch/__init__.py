"""Launchers: ``serve_studies`` drives the front-door study gateway.

The JAX package's other launchers (``train``, ``dryrun``, ``hillclimb``,
``specs``, ``mesh``) need the mesh plane and its sharding rules, and are
ROADMAP queue A, slices 8 and 9.
"""
