"""Launchers: ``serve`` (the batched serving loop for an architecture)
and ``train`` (``small_config``)."""
