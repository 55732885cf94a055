"""The fault-tolerant checkpointer (port of ``repro/checkpoint``)."""
