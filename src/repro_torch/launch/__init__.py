"""Launchers: ``serve_studies`` drives the front-door study gateway,
``train`` trains one architecture on the local mesh (``specs`` holds its
input stand-ins).

The JAX package's ``dryrun``, ``hillclimb`` and ``mesh`` are ROADMAP
queue A, slice 9.
"""
