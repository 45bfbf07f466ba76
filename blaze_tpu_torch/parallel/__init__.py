"""Exchanges: hash, round-robin, range and single-partition shuffles,
in process or through files, and the broadcast exchange."""

from .shuffle import (
    HashPartitioning, IpcReaderExec, LocalShuffleManager, Partitioning, RangePartitioning, RoundRobinPartitioning,
    ShuffleWriterExec, SinglePartitioning,
)

__all__ = [
    "Partitioning", "HashPartitioning", "SinglePartitioning", "RangePartitioning", "RoundRobinPartitioning",
    "ShuffleWriterExec", "IpcReaderExec", "LocalShuffleManager",
]
