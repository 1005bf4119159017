"""Per-layer metrics, one reader a file: ``read(ctx)`` takes a
``context.Context`` of the traced run and returns the metric's value, or
None where the run has nothing for it to read."""
