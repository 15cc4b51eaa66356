"""Probes of the card: the gather probe (P0)."""
