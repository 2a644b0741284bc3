"""Metrics (Prometheus when installed)."""
