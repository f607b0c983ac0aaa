"""Host-side tools: the single-sphere Mie series (tools/mie.py)."""
