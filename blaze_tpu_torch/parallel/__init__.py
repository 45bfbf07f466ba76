"""Exchanges: hash and single-partition shuffles kept in process, and
the broadcast exchange."""
