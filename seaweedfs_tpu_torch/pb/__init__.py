"""Heartbeat and shard-information messages."""
