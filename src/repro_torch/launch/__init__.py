"""Launchers: ``serve_studies`` drives the front-door study gateway,
``train`` trains one architecture on the local mesh (``specs`` holds its
input stand-ins), ``dryrun`` runs every (arch × shape × mesh) case —
abstract at production size on a fake 256- or 512-rank mesh
(``mesh``), or reduced for real on the local device — and ``hillclimb``
runs a case again under variant sharding or config rules and compares its
roofline terms (:mod:`repro_torch.analysis`).
"""
