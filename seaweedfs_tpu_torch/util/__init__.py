"""Host utilities: logging, failpoints, tracing, events, caches, CRC32C."""
