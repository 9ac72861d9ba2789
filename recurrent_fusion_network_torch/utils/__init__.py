"""Utilities of the port: the JSONL event log and the build of the host C++
libraries."""
