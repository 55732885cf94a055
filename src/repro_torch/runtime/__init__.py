"""Fault injection and fault tolerance (ports of ``repro/runtime``)."""
