"""Utilities of the port: the JSONL event log."""
