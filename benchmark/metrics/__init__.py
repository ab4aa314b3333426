"""Per-layer metric readers: <metric name>.py each defines read(ctx)."""
