"""Entry points: ``python -m repro_torch.launch.serve_genomics``,
``.train``, ``.dryrun`` and ``.report``."""
