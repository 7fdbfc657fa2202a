"""Corpus synthesis and the parity legs of the port."""
