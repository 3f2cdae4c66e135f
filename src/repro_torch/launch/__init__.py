"""Launchers of the port: :mod:`.serve` (LM and recsys serving) and
:mod:`.train` (training, every family)."""
