"""Drivers, one module a protocol, found by the ``driver`` name of a mix."""
