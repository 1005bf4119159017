"""Training many DSE cells at once: ``cellfarm`` shards pending cells over
spawned processes, ``cellstack`` trains cells of one shape as one slab on
the card, and ``fleet`` spools them to lease-holding workers on any host
that mounts the cache root.  All publish through the content-addressed
``TraceCache``, so every consumer sees ordinary cache hits afterwards.
``fault_tolerance`` supervises one training loop with checkpoints and
restarts."""
