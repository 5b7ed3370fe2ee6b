"""Enums and host-side f64 schedule tables."""
