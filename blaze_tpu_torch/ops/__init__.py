"""Physical operators (≙ ``blaze_tpu/ops``)."""

from .agg import AggExec, AggFunction, AggMode, GroupingExpr
from .base import ExecNode
from .expand import ExpandExec
from .filter import FilterExec
from .limit import LimitExec
from .memory_scan import MemoryScanExec
from .project import ProjectExec
from .rename import RenameColumnsExec
from .sort import SortExec, SortField
from .union import UnionExec
from .window import WindowExec, WindowFunction

__all__ = [
    "AggExec", "AggFunction", "AggMode", "ExecNode", "ExpandExec", "FilterExec", "GroupingExpr",
    "LimitExec", "MemoryScanExec", "ProjectExec", "RenameColumnsExec", "SortExec", "SortField", "UnionExec",
    "WindowExec", "WindowFunction",
]
