"""Shared benchmark code: it names no configuration, traffic mix or metric."""
