"""Roofline terms and report tables from the dry run's records
(:mod:`repro_torch.launch.dryrun`)."""
