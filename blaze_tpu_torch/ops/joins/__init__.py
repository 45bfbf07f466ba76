"""Joins over a sorted key table (≙ ``blaze_tpu/ops/joins``): build
keys hash to 64 bits and sort; probes find their candidate ranges in
the sorted table, expand them into pairs, and every pair is verified
against the real key columns, so hash collisions and null keys never
produce a wrong match."""

from .broadcast import BroadcastJoinBuildHashMapExec, BroadcastJoinExec, clear_join_map_cache
from .core import Joiner, JoinerState, JoinMap, JoinType
from .hash_join import HashJoinExec

__all__ = ["BroadcastJoinBuildHashMapExec", "BroadcastJoinExec", "HashJoinExec", "Joiner", "JoinerState", "JoinMap",
           "JoinType", "clear_join_map_cache"]
