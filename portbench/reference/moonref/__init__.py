"""Frozen copies of the port's plain modules at commit 41cfce49f52c.

The benchmark's reference renders from these; nothing here imports
the port, and nothing here launches a hand-written kernel."""
