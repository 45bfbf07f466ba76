"""Joins over a sorted key table (≙ ``blaze_tpu/ops/joins``): build
keys hash to 64 bits and sort; probes find their candidate ranges in
the sorted table, expand them into pairs, and every pair is verified
against the real key columns, so hash collisions and null keys never
produce a wrong match."""

from .broadcast import BroadcastJoinExec
from .core import JoinMap, JoinType
from .hash_join import HashJoinExec

__all__ = ["BroadcastJoinExec", "HashJoinExec", "JoinMap", "JoinType"]
