"""Physical operators (≙ ``blaze_tpu/ops``)."""

from .agg import AggExec, AggFunction, AggMode, GroupingExpr
from .base import ExecNode
from .bloom_agg import BloomFilterAggExec
from .coalesce import CoalesceBatchesExec
from .debug import DebugExec
from .empty import EmptyPartitionsExec
from .expand import ExpandExec
from .filter import FilterExec
from .generate import GenerateExec, NativeGenerator
from .limit import LimitExec
from .memory_scan import MemoryScanExec
from .object_agg import ObjectAggExec, Udaf
from .orc_scan import OrcScanExec
from .parquet_scan import ParquetScanExec
from .parquet_sink import ParquetSinkExec
from .project import ProjectExec
from .rename import RenameColumnsExec
from .sort import SortExec, SortField
from .union import UnionExec
from .window import WindowExec, WindowFunction

__all__ = [
    "AggExec", "AggFunction", "AggMode", "BloomFilterAggExec", "CoalesceBatchesExec", "DebugExec", "EmptyPartitionsExec", "ExecNode",
    "ExpandExec", "FilterExec", "GenerateExec", "GroupingExpr", "NativeGenerator", "LimitExec", "MemoryScanExec", "ObjectAggExec", "OrcScanExec", "ParquetScanExec",
    "ParquetSinkExec", "ProjectExec", "RenameColumnsExec", "SortExec", "SortField", "Udaf", "UnionExec", "WindowExec",
    "WindowFunction",
]
