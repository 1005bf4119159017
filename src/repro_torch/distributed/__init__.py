"""Training many DSE cells at once: ``cellfarm`` shards pending cells over
spawned processes, ``cellstack`` trains cells of one shape as one slab on
the card.  Both publish through the content-addressed ``TraceCache``, so
every consumer sees ordinary cache hits afterwards."""
