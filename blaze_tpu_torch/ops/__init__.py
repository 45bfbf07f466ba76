"""Physical operators (≙ ``blaze_tpu/ops``)."""

from .agg import AggExec, AggFunction, AggMode, GroupingExpr
from .base import ExecNode
from .filter import FilterExec
from .limit import LimitExec
from .memory_scan import MemoryScanExec
from .project import ProjectExec
from .sort import SortExec, SortField

__all__ = [
    "AggExec", "AggFunction", "AggMode", "ExecNode", "FilterExec", "GroupingExpr",
    "LimitExec", "MemoryScanExec", "ProjectExec", "SortExec", "SortField",
]
