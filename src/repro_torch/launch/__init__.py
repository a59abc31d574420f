"""Serving entry points: ``serve`` (generate, generate_scan, SlotServer,
CLI) and ``adapters`` (the multi-tenant factor store)."""
